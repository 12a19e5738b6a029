"""Device-idle ms a call at the call boundary, outside the forward: the
untraced call's idle, in the share of the idle of the traced slice that
records host ops whose gaps have their midpoint inside the program's spans
``predict.upload``, ``predict.fetch`` or ``predict.poses`` (``lib.spans.idle_ms``).
Gaps in the caller's own loop, between calls, are not counted."""

from portbench.lib import spans

SPANS = ("predict.upload", "predict.fetch", "predict.poses")


def read(reading):
    return spans.idle_ms(reading, SPANS)
