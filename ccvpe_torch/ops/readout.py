"""On-device pose readout (counterpart of the readout in
``ccvpe_tpu/api.py`` and ``ccvpe_tpu/ops/readout.py``).

Softmax is monotonic, so the peak comes from the logits: the row-major
first maximum (``torch.argmax`` returns the first of equal maxima, like
``np.argmax``).  The probability at the peak is exp(l_max - logsumexp(l)) in
f32, and the heatmap is only materialised when asked for.
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
    flat = torch.argmax(logits, dim=1)
    row, col = flat // w, flat % w
    l32 = logits.float()
    prob = torch.exp(l32[idx, flat] - torch.logsumexp(l32, dim=1))
    res = {"row": row, "col": col, "prob": prob,
           "cos": out.ori[idx, row, col, 0], "sin": out.ori[idx, row, col, 1]}
    if want_heatmap:
        res["heatmap"] = out.heatmap[..., 0]
    return res
