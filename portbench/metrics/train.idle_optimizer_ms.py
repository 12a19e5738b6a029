"""Device-idle ms a step in the optimizer: the untraced step's idle, in the
share of the idle of the traced slice that records host ops whose gaps have
their midpoint inside the program's spans ``train_step.zero_grad`` or
``train_step.optimizer`` (the gradients' reset; the gradient norm and Adam;
``lib.spans.idle_ms``)."""

from portbench.lib import spans

SPANS = ("train_step.zero_grad", "train_step.optimizer")


def read(reading):
    return spans.idle_ms(reading, SPANS)
