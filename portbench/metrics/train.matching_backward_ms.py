"""Device ms a step of the matching kernels' backward: the kernels launched
under the program's span ``matching.backward`` (autograd through the plain
matching, on autograd's thread)."""

from portbench.lib import spans

SPANS = ("matching.backward",)


def read(reading):
    return spans.under_ms(reading["trace"], SPANS)
