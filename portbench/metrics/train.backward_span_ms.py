"""Device ms a step of the backward, read from the program's span
``train_step.backward``: the kernels launched by ops, on any thread, that
start while the span is open (the backward call blocks until autograd's
own thread has launched the whole backward)."""

from portbench.lib import spans

SPANS = ("train_step.backward",)


def read(reading):
    return spans.launched_in_ms(reading["trace"], SPANS)
