"""Kernel K2 of ``csrc/matching.cu`` against its roofline in a cell whose
``fov`` crops the panorama: the least time of the launches of one forward
of the cropped model (``lib.fov.launches``: at VIGOR's sizes with the
+-36 degree prior, six masked 5-bin launches, x counted over the 896 of
1280 channels (70 %) that their windows read, and the 20-bin bottleneck
stack; bytes over 3.35 TB/s or operations over the float32 peak, each
input read once and each output written once) over their device time a
call in the trace, the kernels named as ``k2_roofline`` names them."""

from portbench.lib import fov


def read(reading):
    return fov.roofline_pct(reading, "K2")
