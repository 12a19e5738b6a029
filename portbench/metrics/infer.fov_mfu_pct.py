"""Model FLOP utilization of offline localization in a cell whose ``fov``
crops the panorama: the plain reference's forward operations per pair of
the cropped model (``lib.fov``: the narrower ground image without circular
padding, the prior's bins) times the pairs/s of the run's window, over the
card's float32 peak."""

from portbench.lib import fov, readers
from portbench.reference import flops


def read(reading):
    batch = reading["readings"]["batch"]
    per_pair = flops.forward_flops(fov.arch(reading), batch, readers.loc_offsets(reading)) / batch
    return readers.mfu_pct(reading, per_pair, "pairs_per_s")
