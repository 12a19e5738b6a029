"""Device ms a call of the kernels launched under ATen convolution ops
(``models.cvm`` and ``nn.layers``: cuDNN's convolutions and their
transposes), from the profiler's op-to-kernel correlation in the traced
slice that records host ops."""

from portbench.lib import trace as trace_lib


def _conv(name: str) -> bool:
    return name.startswith("aten::") and "conv" in name


def read(reading):
    t = reading["trace"]
    if t is None or not t.op_iters:
        return None
    spent = trace_lib.under(t, _conv)
    return spent / t.op_iters * 1e3 if spent > 0 else None
