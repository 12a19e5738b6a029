"""Device ms a call of the two decoders: the kernels launched under the
program's spans ``cvm.localization_decoder`` (the six matching and
upsampling stages, K1 and K2 among them, and the softmax) and
``cvm.orientation_decoder``, from the traced slice that records host ops."""

from portbench.lib import spans

SPANS = ("cvm.localization_decoder", "cvm.orientation_decoder")


def read(reading):
    return spans.under_ms(reading["trace"], SPANS)
