"""Building the program under test (``ccvpe_torch``) from the benchmark's
weights, and reading its answers against the plain reference."""

from __future__ import annotations

import math

import numpy as np
import torch

from ..reference import cvm as ref


def preset(config: dict, arch: ref.Arch):
    """The program's preset named by the configuration; its sizes must be
    the configuration's."""
    from ccvpe_torch.models import cvm

    cfg = cvm.PRESETS[config["preset"]]
    for name in ref.Arch._fields:
        got, want = getattr(cfg, name), getattr(arch, name)
        if (tuple(got) if isinstance(got, (list, tuple)) else got) != want:
            raise SystemExit(f"preset {config['preset']}: {name} is {got}, the "
                             f"configuration file says {want}")
    return cfg


def serving_model(cfg, sd: dict, device, precision: dict, ori_noise: float):
    """An ``api.CVMModel`` holding a copy of ``sd`` (loaded strictly, as
    ``api.load_model`` loads a reference checkpoint) in eval mode, in
    ``precision`` (``harness.precision_of``): quantized to int8 by the API
    (calibrated at ``ori_noise``'s offsets) where it says so."""
    from ccvpe_torch import api
    from ccvpe_torch.models import cvm

    if precision["compute_dtype"] != "float32":
        raise SystemExit(f"the API serves float32 alone, not {precision['compute_dtype']}")

    with torch.device("meta"):
        net = cvm.CVM(cfg)
    net.load_state_dict({k: v.clone() for k, v in sd.items()}, strict=True, assign=True)
    net = net.eval().to(device=device, memory_format=torch.channels_last)
    model = api.CVMModel(cfg, net, device)
    if precision["quantize"] == "int8":
        model.quantize_int8(ori_noise=ori_noise)
    return model


def loc_offsets(ori_noise: float):
    """The localization branch's orientation bins for a request's
    ``ori_noise`` as the API reads it: all bins (None) from 180 degrees
    up, else the prior's offsets ``range(-n, n + 1)``, n = ori_noise // 18."""
    if ori_noise >= 180:
        return None
    n = int(ori_noise // 18)
    return range(-n, n + 1)


def heading_deg(cos: float, sin: float) -> float:
    """The heading of a (cos, sin) pair as the evaluation reads it: acos,
    negated where sin < 0."""
    a = math.degrees(math.acos(min(1.0, max(-1.0, cos))))
    return (-a) % 360 if sin < 0 else a


def angular_deg(a: float, b: float) -> float:
    d = abs(a - b) % 360
    return min(d, 360 - d)


def reference_at(out: ref.Outputs, picks: list[tuple[int, int, int]]) -> list[tuple]:
    """(probability, heading, length) of the reference at each (sample,
    row, col): exp(l - logsumexp(l)) in float64 from its logits; its
    heading; and its orientation field's length there before normalising,
    over the median length of that sample's field."""
    w = out.ori.shape[2]
    dev = out.logits.device
    lse = torch.logsumexp(out.logits.double(), dim=1).cpu().numpy()
    median = out.ori_norm.flatten(1).median(dim=1).values.double().cpu().numpy()
    idx, rows, cols = (torch.tensor(v, device=dev) for v in zip(*picks))
    logit = out.logits[idx, rows * w + cols].double().cpu().numpy()
    ori = out.ori[idx, rows, cols].double().cpu().numpy()
    length = out.ori_norm[idx, rows, cols].double().cpu().numpy()
    return [(float(np.exp(lg - lse[b])), heading_deg(o[0], o[1]), float(n / median[b]))
            for (b, _, _), lg, o, n in zip(picks, logit, ori, length)]


def pose_gaps(answers: list[tuple], refs: list[tuple]) -> tuple[float, float]:
    """Two numbers over all answers, each the widest:

    * ``prob_rel``: the program's probability at its peak against the
      reference's probability at that pixel, relative to the latter;
    * ``ori_gap``: the angle (radians) between the program's heading and
      the reference's there, times the reference's field length there over
      its median length.  The heading is the direction of a two-channel
      field normalised to length 1; where that field is short, a rounding
      of its channels turns it by a wide angle, so the angle alone reads
      the field's length more than the program's error.  Scaled so, the
      number is the gap between the two fields, as a share of the field's
      typical length.

    ``answers``: (probability, heading) of the program; a missing
    probability or heading (NaN) reads as infinitely far."""
    prob, ori = 0.0, 0.0
    for (p, h), (rp, rh, rn) in zip(answers, refs):
        gp = abs(p - rp) / rp if rp > 0 and math.isfinite(p) else math.inf
        go = math.radians(angular_deg(h, rh)) * rn if math.isfinite(h) else math.inf
        prob, ori = max(prob, gp), max(ori, go)
    return prob, ori
