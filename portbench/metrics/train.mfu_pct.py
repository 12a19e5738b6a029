"""Model FLOP utilization of training: the plain reference's forward,
losses and backward operations per sample (no recompute) times the
samples/s of the run's window, over the card's float32 peak."""

from portbench.lib import readers
from portbench.reference import flops


def read(reading):
    batch = reading["readings"]["batch"]
    per_sample = flops.train_flops(readers.arch(reading), batch) / batch
    return readers.mfu_pct(reading, per_sample, "samples_per_s")
