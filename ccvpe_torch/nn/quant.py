"""Post-training int8 quantization (PTQ) for inference, the counterpart of
``ccvpe_tpu/nn/quant.py``.

1. ``calibrate``: run a few batches through the unmodified forward with a
   forward pre-hook on every conv that JAX's ``conv_apply`` observes, and
   record each one's input ``max|x|`` (before its padding).  The running
   maxima stay on the device; each batch fetches them to the host once.
2. ``quantize_params``: swap each selected conv for a ``layers.QuantConv2d``
   with per-output-channel symmetric int8 weights (``q_sw``) and the
   calibrated per-tensor activation scale (``q_sx``).  The model code is
   untouched: every call site of the swapped module reaches the int8 conv.

The observed convs are the backbones' (stem, expand, depthwise, the SE pair,
project, head), the ground descriptor heads' 1x1 convs
(``grd_feature_to_descriptor{k}.0``) and the decoders' double convs.  The
heads' height collapse ``grd_feature_to_descriptor{k}.2`` is not one (the
model reads its weight directly, as JAX's ``conv_h``), and neither are the
deconvs, the satellite descriptor ``Linear`` or the matching, which all
stay in the input's dtype.  Depthwise convs are observed but no policy
selects them.

The codes and scales are computed on the host in numpy, as JAX computes
them, so both packages give the same bits from the same ranges.  Quantized
models are inference-only artifacts; derive them from a float model.
"""

from __future__ import annotations

import re
from typing import Any, Callable, Iterable

import numpy as np
import torch
from torch import nn

from .layers import QuantConv2d

Select = Callable[[str, nn.Module], bool]

# the ground descriptor heads' height collapse: a conv module whose weight
# the model reads directly (JAX's ``conv_h``), never run as a conv
_CONV_H = re.compile(r"(^|\.)grd_feature_to_descriptor\d+\.2$")


def observed_convs(net: nn.Module) -> list[tuple[str, nn.Module]]:
    """(name, module) of every conv that runs as a conv in the forward:
    ``nn.Conv2d`` (``StaticPadConv2d`` included) and ``QuantConv2d``, the
    height collapse left out."""
    return [(name, m) for name, m in net.named_modules()
            if isinstance(m, (nn.Conv2d, QuantConv2d)) and not _CONV_H.search(name)]


@torch.no_grad()
def calibrate(net: nn.Module, batches: Iterable[tuple],
              forward: Callable[..., Any] | None = None) -> dict[str, float]:
    """Run ``forward(*batch)`` (default ``net(*batch)``) over the calibration
    ``batches`` and return ``{module name: input absmax}`` as host floats,
    the running max over every call of each conv."""
    forward = net if forward is None else forward
    convs = observed_convs(net)
    maxes: list[torch.Tensor | None] = [None] * len(convs)

    def observer(i):
        def hook(module, args):
            m = args[0].detach().float().abs().amax()
            maxes[i] = m if maxes[i] is None else torch.maximum(maxes[i], m)
        return hook

    handles = [m.register_forward_pre_hook(observer(i)) for i, (_, m) in enumerate(convs)]
    acc: dict[str, float] = {}
    try:
        for batch in batches:
            maxes[:] = [None] * len(convs)
            forward(*batch)
            ran = [i for i, m in enumerate(maxes) if m is not None]
            if not ran:
                continue
            values = torch.stack([maxes[i] for i in ran]).cpu().tolist()
            for i, v in zip(ran, values):
                name = convs[i][0]
                acc[name] = max(acc.get(name, 0.0), v)
    finally:
        for h in handles:
            h.remove()
    return acc


def default_select(name: str, conv: nn.Module) -> bool:
    """Quantize every observed conv except depthwise (OIHW with I/g == 1),
    as JAX's default policy does."""
    w = conv.weight
    return w.ndim == 4 and w.shape[1] > 1


def mxu_bound_select(threshold: float = 240.0) -> Select:
    """Policy: quantize only the convs whose per-output-pixel arithmetic
    intensity ``K²·Cin·Cout / (Cin + Cout)`` reaches ``threshold`` (the
    activation traffic dominates; the weights amortize over the batch).
    Depthwise convs never qualify.

    The default threshold is JAX's, so that both packages pick the same
    convs.  That number was set from another accelerator's compute to
    bandwidth ratio; on this port the policy is a knob for measurement,
    and ``all`` stays the default."""

    def select(name: str, conv: nn.Module) -> bool:
        w = conv.weight
        if w.ndim != 4 or w.shape[1] == 1:
            return False
        cout, cin_g, kh, kw = w.shape
        intensity = kh * kw * cin_g * cout / max(cin_g + cout, 1)
        return intensity >= threshold

    return select


def resolve_select(spec: str) -> Select:
    """Parse a selection-policy string: ``"all"`` (every non-depthwise conv),
    ``"mxu"`` or ``"mxu:<threshold>"`` (``mxu_bound_select``)."""
    if spec in ("", "all"):
        return default_select
    if spec == "mxu" or spec.startswith("mxu:"):
        if ":" in spec:
            raw = spec.split(":", 1)[1]
            try:
                t = float(raw)
            except ValueError:
                raise ValueError(
                    f"bad mxu threshold {raw!r} in quant selection policy "
                    f"{spec!r} (expected mxu:<float>)") from None
        else:
            t = 240.0
        return mxu_bound_select(t)
    raise ValueError(f"unknown quant selection policy {spec!r}")


def _quantize_conv(conv: nn.Conv2d, absmax: float, eps: float = 1e-12) -> QuantConv2d:
    """The int8 form of ``conv`` (JAX ``quant._quantize_conv``): per output
    channel ``sw = absmax_o / 127`` and codes ``round(w / sw)`` clipped to
    +-127, in float32 with ties to even; ``q_sx`` the Python-float
    ``max(absmax, eps) / 127`` rounded to float32."""
    w = conv.weight.detach().float().cpu().numpy()     # OIHW
    w_absmax = np.maximum(np.abs(w).max(axis=(1, 2, 3)), eps)
    sw = (w_absmax / 127.0).astype(np.float32)
    wq = np.clip(np.round(w / sw[:, None, None, None]), -127, 127).astype(np.int8)
    sx = np.float32(max(absmax, eps) / 127.0)
    q = QuantConv2d(conv, torch.from_numpy(wq), torch.from_numpy(sw), torch.tensor(sx),
                    conv.bias)
    return q.to(conv.weight.device)


def swap_module(net: nn.Module, name: str, module: nn.Module) -> None:
    """Put ``module`` in the place of ``net``'s submodule ``name``."""
    parent, _, child = name.rpartition(".")
    setattr(net.get_submodule(parent), child, module)


def quantize_params(net: nn.Module, ranges: dict[str, float], *,
                    select: Select = default_select) -> nn.Module:
    """Swap, in place, every float conv of ``net`` that (a) appears in
    ``ranges`` (it ran as a conv during calibration: no deconv, no linear
    layer, no height collapse) and (b) passes ``select`` for its int8 form;
    return ``net``.  A conv that is already int8 stays as it is:
    re-quantizing would read its codes as float weights."""
    for name, m in observed_convs(net):
        if isinstance(m, nn.Conv2d) and name in ranges and select(name, m):
            swap_module(net, name, _quantize_conv(m, ranges[name]))
    return net


# JAX's ``quantized_fraction`` leaves out every weight whose path holds
# "conv_h", which matches the backbones' ``conv_head`` as well as the
# collapse; the port counts the same weights, so the two fractions agree
_NOT_COUNTED = re.compile(r"(^|\.)_conv_head$")


def quantized_fraction(net: nn.Module) -> float:
    """Fraction of the QUANTIZABLE conv-weight elements stored as int8.

    The denominator is the observed convs' weights: deconvs and the height
    collapse, which can never run through the int8 conv, are left out, and
    so are the backbones' head convs, as JAX's count leaves them out.
    Depthwise convs count: they are quantizable, only no policy selects
    them, so a default-policy model reports the policy's true coverage."""
    total = q = 0
    for name, m in observed_convs(net):
        if _NOT_COUNTED.search(name):
            continue
        n = m.weight.numel()
        total += n
        if isinstance(m, QuantConv2d):
            q += n
    return q / max(total, 1)
