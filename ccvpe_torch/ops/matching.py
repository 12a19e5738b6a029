"""Orientation-aware rolled-channel cross-view matching (counterpart of
``ccvpe_tpu/ops/matching.py``).

Per orientation bin i the reference rolls the satellite feature map by
``-offset_i * shift`` channels, takes a window of Cg channels starting at
``start`` and scores its cosine similarity with the ground descriptor.
Window channel j of bin i is ``x[(start + offset_i*shift + j) mod Cs]``, so
with ``k_i = (start + offset_i*shift) mod Cs`` every bin reduces to a
product of x with a rolled copy of the zero-padded descriptor:

    num[b,p,i] = sum_c x[b,p,c] * gp[b, (c - k_i) mod Cs]
    sq [b,p,i] = sum_c x[b,p,c]^2 * [(c - k_i) mod Cs < Cg]
    score      = num / max(sqrt(sq) * ||g_b||, 1e-12)

Everything is NHWC: x [B, H, W, Cs], g [B, Cg], scores [B, H, W, bins].

Two functions carry the model's matching, each with a plain PyTorch version
here and a CUDA kernel in ``matching_cuda``:

* ``matching_scores``: the scores (kernel K2).
* ``matching_epilogue`` (Cg == Cs only): the scores plus the decoder stage's
  epilogue, max over bins and the l2-normalised x, from one read of x
  (kernel K1).

Both dispatch on the tensor's device: a CPU tensor takes the plain version,
a CUDA tensor launches the kernel or raises.

The plain versions clamp the score denominator at 1e-12 as the kernels do.
The JAX einsum path does not, so the two differ only where ||x|| = 0 (0
here, NaN there).
"""

from __future__ import annotations

import torch


def window_start(cs: int, cg: int, window: str) -> int:
    """'first' -> 0 (VIGOR, KITTI); 'center' -> (Cs - Cg) // 2 (Oxford)."""
    if window == "first":
        return 0
    if window == "center":
        return (cs - cg) // 2
    raise ValueError(f"unknown window mode {window!r}")


def bin_shifts(cs: int, cg: int, shift: int, offsets, window: str) -> tuple[int, ...]:
    """k_i = (start + offset_i * shift) mod Cs, non-negative (Python ``%``)
    also for the negative offsets of the orientation prior."""
    start = window_start(cs, cg, window)
    return tuple((start + int(o) * shift) % cs for o in offsets)


def _window_mask(cs: int, cg: int, ks: tuple[int, ...], device) -> torch.Tensor:
    """[Cs, bins] 0/1 mask: M[c, i] = channel c inside the window of bin i
    (built on the device from Python ints: no host-to-device copy)."""
    c = torch.arange(cs, device=device)
    return torch.stack([(c - k) % cs < cg for k in ks], dim=1).to(torch.float32)


def _banded(g: torch.Tensor, cs: int, ks: tuple[int, ...]) -> torch.Tensor:
    """[B, Cs, bins] f32: column i is the zero-padded descriptor rolled by k_i."""
    gp = torch.nn.functional.pad(g.float(), (0, cs - g.shape[-1]))
    return torch.stack([torch.roll(gp, k, dims=1) for k in ks], dim=-1)


def matching_scores_plain(x: torch.Tensor, g: torch.Tensor, shift: int,
                          offsets, window: str = "first") -> torch.Tensor:
    """Plain PyTorch version of kernel K2: [B,H,W,Cs] x [B,Cg] -> [B,H,W,bins]
    scores in x's dtype, accumulated in f32."""
    cs, cg = x.shape[-1], g.shape[-1]
    ks = bin_shifts(cs, cg, shift, offsets, window)
    xf = x.float()
    num = torch.einsum("bhwc,bci->bhwi", xf, _banded(g, cs, ks))
    if cg == cs:
        sq = (xf * xf).sum(dim=-1, keepdim=True)
    else:
        sq = torch.einsum("bhwc,ci->bhwi", xf * xf,
                          _window_mask(cs, cg, ks, x.device))
    gnorm = g.float().square().sum(dim=-1).sqrt()[:, None, None, None]
    return (num / torch.clamp(sq.sqrt() * gnorm, min=1e-12)).to(x.dtype)


def matching_epilogue_plain(x: torch.Tensor, g: torch.Tensor, shift: int,
                            offsets, window: str = "first"
                            ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel K1 (Cg == Cs): returns
    ``(scores [B,H,W,bins], max over bins [B,H,W,1], x / max(||x||, 1e-12))``,
    all in x's dtype; the max is taken in f32 before the cast."""
    cs, cg = x.shape[-1], g.shape[-1]
    if cg != cs:
        raise ValueError(f"matching_epilogue needs Cg == Cs, got {cg} != {cs}")
    ks = bin_shifts(cs, cg, shift, offsets, window)
    xf = x.float()
    num = torch.einsum("bhwc,bci->bhwi", xf, _banded(g, cs, ks))
    norm = (xf * xf).sum(dim=-1, keepdim=True).sqrt()
    gnorm = g.float().square().sum(dim=-1).sqrt()[:, None, None, None]
    scores = num / torch.clamp(norm * gnorm, min=1e-12)
    smax = scores.amax(dim=-1, keepdim=True)
    xnorm = xf / torch.clamp(norm, min=1e-12)
    return scores.to(x.dtype), smax.to(x.dtype), xnorm.to(x.dtype)


def matching_scores_reference(x: torch.Tensor, g: torch.Tensor, shift: int,
                              offsets, window: str = "first") -> torch.Tensor:
    """The reference's roll-and-slice loop, one pass per bin (tests only)."""
    cs, cg = x.shape[-1], g.shape[-1]
    start = window_start(cs, cg, window)
    gnorm = g.square().sum(dim=-1).sqrt()[:, None, None]
    scores = []
    for i in offsets:
        win = torch.roll(x, -int(i) * shift, dims=-1)[..., start:start + cg]
        wnorm = win.square().sum(dim=-1).sqrt()
        num = (win * g[:, None, None, :]).sum(dim=-1)
        scores.append(num / (wnorm * gnorm))
    return torch.stack(scores, dim=-1)


def matching_scores(x: torch.Tensor, g: torch.Tensor, shift: int, offsets,
                    window: str = "first") -> torch.Tensor:
    """Scores of every bin in ``offsets``: the plain version for a CPU
    tensor, kernel K2 for a CUDA tensor."""
    from .matching_cuda import matching_scores_cuda

    return matching_scores_cuda(x, g, shift, offsets, window)


def matching_epilogue(x: torch.Tensor, g: torch.Tensor, shift: int, offsets,
                      window: str = "first"
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(scores, max over bins, l2-normalised x) for Cg == Cs: the plain
    version for a CPU tensor, kernel K1 for a CUDA tensor."""
    from .matching_cuda import matching_epilogue_cuda

    return matching_epilogue_cuda(x, g, shift, offsets, window)
