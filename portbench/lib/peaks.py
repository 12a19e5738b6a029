"""Published peaks of the cards the benchmark may run on (NVIDIA data
sheets, dense rates, at the full power limit), and the least time a piece
of work can take on one.  A roofline share or a utilization is stated
against these peaks, with the card's power limit beside it."""

from __future__ import annotations

# part -> (device-memory bytes/s, float32 FLOP/s outside the tensor cores,
# bfloat16 FLOP/s on the tensor cores)
PEAKS = {"H100 SXM": (3.35e12, 67e12, 989e12), "H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12)}


def part_of(device_name: str) -> str:
    """The data-sheet part of a card from ``torch.cuda.get_device_name``."""
    return "H100 PCIe" if "PCIe" in device_name else "H100 NVL" if "NVL" in device_name \
        else "H100 SXM"


def bound_s(nbytes: float, flops: float, part: str) -> float:
    """The least seconds for the work in float32: bytes over the memory
    rate or operations over the float32 peak, whichever is larger."""
    bw, f32, _ = PEAKS[part]
    return max(nbytes / bw, flops / f32)
