"""Device ms a step of the backward: the kernels of the traced steps
outside the program's ranges ``train_step.forward`` (forward and losses)
and ``train_step.optimizer`` (gradient norm and Adam) and outside the
benchmark's feed (``portbench.feed``).  Autograd runs the backward on its
own thread, outside every range."""

from portbench.lib import trace as trace_lib

OUTSIDE = ("train_step.forward", "train_step.optimizer", "portbench.feed")


def read(reading):
    t = reading["trace"]
    if t is None or not t.op_iters:
        return None
    seen = set()
    inside = 0.0
    for name in OUTSIDE:
        s = trace_lib.under(t, lambda n, name=name: n == name)
        if s > 0:
            seen.add(name)
        inside += s
    if "train_step.forward" not in seen:
        return None   # the program no longer marks its forward
    rest = trace_lib.kernel_s(t) - inside
    return rest / t.op_iters * 1e3 if rest > 0 else None
