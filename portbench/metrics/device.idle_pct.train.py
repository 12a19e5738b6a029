"""The share of an iteration of the untraced window in which no operation
ran on the card: the union of the device intervals an iteration in the
profiler's lean slice, over the window's seconds an iteration."""

from portbench.lib import readers


def read(reading):
    return readers.idle_pct(reading)
