"""Model FLOP utilization of offline localization: the plain reference's
forward operations per pair (``reference.flops``) times the pairs/s of the
run's window, over the card's float32 peak."""

from portbench.lib import readers
from portbench.reference import flops


def read(reading):
    batch = reading["readings"]["batch"]
    per_pair = flops.forward_flops(readers.arch(reading), batch, readers.loc_offsets(reading)) / batch
    return readers.mfu_pct(reading, per_pair, "pairs_per_s")
