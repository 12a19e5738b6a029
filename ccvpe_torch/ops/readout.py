"""On-device pose readouts (counterparts of the readout in
``ccvpe_tpu/api.py`` and of ``ccvpe_tpu/ops/readout.py``).

``pose_readout`` is the API's readout (prediction only).  The eval readouts
also read the GT: ``pose_readout_from_outputs`` (the eval step's; peak from
the logits) and ``pose_readout_with_gt`` (from a materialised heatmap).

The peak is the row-major first maximum (``torch.argmax`` returns the first
of equal maxima, like ``np.argmax``).  When the heatmap is asked for, the
peak and its probability are read from the heatmap itself, as the JAX
readout does: two distinct logits can round to one f32 softmax value, and
the heatmap's first maximum then differs from the logits'.  Without the
heatmap, softmax being monotonic, the peak comes from the logits and the
probability is exp(l_max - logsumexp(l)) in f32, so the heatmap is never
materialised.
"""

from __future__ import annotations

import torch

from ..models.cvm import CVMOutputs


def pose_readout(out: CVMOutputs, want_heatmap: bool = False) -> dict[str, torch.Tensor]:
    """Per-sample [B] tensors ``row``, ``col``, ``prob``, ``cos``, ``sin``
    (plus ``heatmap`` [B, H, W] when ``want_heatmap``)."""
    logits = out.logits_flattened
    b, _, w, _ = out.heatmap.shape
    idx = torch.arange(b, device=logits.device)
    if want_heatmap:
        hm = out.heatmap[..., 0]
        flat = torch.argmax(hm.reshape(b, -1), dim=1)
        prob = hm.reshape(b, -1)[idx, flat].float()
    else:
        flat = torch.argmax(logits, dim=1)
        l32 = logits.float()
        prob = torch.exp(l32[idx, flat] - torch.logsumexp(l32, dim=1))
    row, col = flat // w, flat % w
    res = {"row": row, "col": col, "prob": prob,
           "cos": out.ori[idx, row, col, 0], "sin": out.ori[idx, row, col, 1]}
    if want_heatmap:
        res["heatmap"] = hm
    return res


def _argmax_rc(maps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, H, W] -> (rows, cols) of the row-major first maximum."""
    b, _, w = maps.shape
    flat = torch.argmax(maps.reshape(b, -1), dim=1)
    return flat // w, flat % w


def _gt_readout(pr, pc, gr, gc, prob, ori, gt_orientation) -> dict[str, torch.Tensor]:
    idx = torch.arange(pr.shape[0], device=pr.device)
    return {
        "pred_row": pr, "pred_col": pc, "gt_row": gr, "gt_col": gc,
        "pixel_distance": torch.sqrt((gr - pr).float() ** 2 + (gc - pc).float() ** 2),
        "prob_at_gt": prob,
        "cos_pred": ori[idx, pr, pc, 0].float(), "sin_pred": ori[idx, pr, pc, 1].float(),
        "cos_gt": gt_orientation[idx, gr, gc, 0].float(),
        "sin_gt": gt_orientation[idx, gr, gc, 1].float(),
    }


def pose_readout_from_outputs(out: CVMOutputs, gt: torch.Tensor,
                              gt_orientation: torch.Tensor) -> dict[str, torch.Tensor]:
    """The eval readout of ``ccvpe_tpu/ops/readout.py::pose_readout_from_outputs``
    from the raw outputs, without the heatmap: the predicted peak is the
    logits' row-major first maximum, the probability at the GT peak is
    exp(l_gt - logsumexp(l)) in float32.

    ``gt`` [B, H, W] or [B, H, W, 1], ``gt_orientation`` [B, H, W, 2], NHWC.
    Returns [B] tensors: ``pred_row``/``pred_col``, ``gt_row``/``gt_col``
    (the GT's row-major first maximum), ``pixel_distance``, ``prob_at_gt``,
    predicted (cos, sin) at the predicted peak and GT (cos, sin) at the GT
    peak."""
    logits = out.logits_flattened
    w = out.heatmap.shape[2]
    g = gt if gt.dim() == 3 else gt[..., 0]
    flat = torch.argmax(logits, dim=1)
    gr, gc = _argmax_rc(g)
    l32 = logits.float()
    idx = torch.arange(logits.shape[0], device=logits.device)
    prob = torch.exp(l32[idx, gr * w + gc] - torch.logsumexp(l32, dim=1))
    return _gt_readout(flat // w, flat % w, gr, gc, prob, out.ori, gt_orientation)


def pose_readout_with_gt(heatmap: torch.Tensor, ori: torch.Tensor, gt: torch.Tensor,
                         gt_orientation: torch.Tensor) -> dict[str, torch.Tensor]:
    """The readout of ``ccvpe_tpu/ops/readout.py::pose_readout`` from a
    materialised heatmap [B, H, W, 1]: the predicted peak is the heatmap's
    row-major first maximum and ``prob_at_gt`` the heatmap at the GT peak;
    the keys as ``pose_readout_from_outputs``."""
    hm = heatmap[..., 0]
    g = gt if gt.dim() == 3 else gt[..., 0]
    pr, pc = _argmax_rc(hm)
    gr, gc = _argmax_rc(g)
    idx = torch.arange(hm.shape[0], device=hm.device)
    return _gt_readout(pr, pc, gr, gc, hm[idx, gr, gc].float(), ori, gt_orientation)
