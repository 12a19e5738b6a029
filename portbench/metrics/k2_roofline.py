"""Kernel K2 of ``csrc/matching.cu`` against its roofline: the least time of
its launches in one forward (bytes over 3.35 TB/s or operations over the
float32 peak, each input read once and each output written once, from the
shapes the configuration implies: ``reference.flops.matching_launches``)
over their device time a call in the trace."""

from portbench.lib import readers


def read(reading):
    return readers.roofline_pct(reading, "K2")
