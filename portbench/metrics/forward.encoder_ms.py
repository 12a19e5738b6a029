"""Device ms a call of the two encoders: the kernels launched under the
program's spans ``cvm.ground_encoder`` (the ground EfficientNet and its six
descriptor heads) and ``cvm.aerial_encoder`` (the aerial EfficientNet and
its descriptor grid), from the traced slice that records host ops."""

from portbench.lib import spans

SPANS = ("cvm.ground_encoder", "cvm.aerial_encoder")


def read(reading):
    return spans.under_ms(reading["trace"], SPANS)
