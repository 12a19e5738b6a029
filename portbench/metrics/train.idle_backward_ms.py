"""Device-idle ms a step in the backward: the untraced step's idle, in the
share of the idle of the traced slice that records host ops whose gaps have
their midpoint inside the program's span ``train_step.backward``
(``lib.spans.idle_ms``)."""

from portbench.lib import spans

SPANS = ("train_step.backward",)


def read(reading):
    return spans.idle_ms(reading, SPANS)
