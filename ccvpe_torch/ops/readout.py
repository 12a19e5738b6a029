"""On-device pose readout (counterpart of the readout in
``ccvpe_tpu/api.py`` and ``ccvpe_tpu/ops/readout.py``).

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
