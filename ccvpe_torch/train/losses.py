"""Training objective (counterpart of ``ccvpe_tpu/train/losses.py``): weighted
infoNCE over the six matching-score volumes, cross-entropy over the heatmap
logits and a Gaussian-weighted orientation MSE, all in float32.  Tensors are
NHWC, as the model returns them.
"""

from __future__ import annotations

import torch

from ..nn.layers import max_pool

POSITIVE_THRESHOLD = 1e-2
# the MaxPool2d(2^k) factors of the six score volumes' labels, coarse to fine
POOL_EXPONENTS = (6, 5, 4, 3, 2, 1)


def info_nce_loss(scores: torch.Tensor, labels: torch.Tensor,
                  temperature: float = 0.1, global_mean=None) -> torch.Tensor:
    """Contrastive loss over flattened score volumes [B, N]: cells whose label
    exceeds 1e-2 are positives weighted by their label, the denominator runs
    over every cell of the sample (logsumexp form).  The weighted sum is
    normalised by the batch's total positive weight; ``global_mean`` (a
    rank's total -> the mean of the ranks' totals) makes that total the
    global batch's, so the mean of the ranks' losses is the global one."""
    scores = scores / temperature
    log_prob = scores - torch.logsumexp(scores, dim=1, keepdim=True)
    w = torch.where(labels > POSITIVE_THRESHOLD, labels, torch.zeros_like(labels))
    total = w.sum()
    if global_mean is not None:
        total = global_mean(total)
    return -(log_prob * w).sum() / total


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """-sum(labels * log_softmax(logits)) / B, labels the sum-normalised GT."""
    return -(labels * torch.log_softmax(logits, dim=1)).sum() / logits.shape[0]


def orientation_loss(ori: torch.Tensor, gt_orientation: torch.Tensor,
                     gt: torch.Tensor) -> torch.Tensor:
    """Squared (cos, sin) error weighted by the unnormalised GT Gaussian
    [B, H, W, 1], summed, over B."""
    sq = (gt_orientation - ori).square().sum(dim=-1, keepdim=True)
    return (sq * gt).sum() / ori.shape[0]


def gt_pyramid(gt_with_ori: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """The six score volumes' labels: max-pooled binned GT [B, H, W, bins]."""
    return tuple(max_pool(gt_with_ori, 2 ** k) for k in POOL_EXPONENTS)


def _assemble(outputs, gt_flat, loss_ori, labels, weight_info_nce, weight_ori,
              global_mean=None):
    b = gt_flat.shape[0]
    loss_ce = cross_entropy_loss(outputs.logits_flattened.float(), gt_flat)
    nce = [info_nce_loss(stack.float().reshape(b, -1), label, global_mean=global_mean)
           for stack, label in zip(outputs.matching_scores, labels)]
    loss_nce = sum(nce) / len(nce)
    loss = loss_ce + weight_info_nce * loss_nce + weight_ori * loss_ori
    return loss, {"loss": loss, "ce": loss_ce, "info_nce": loss_nce, "ori": loss_ori}


def _normalized_flat(gt: torch.Tensor) -> torch.Tensor:
    flat = gt.reshape(gt.shape[0], -1)
    return flat / flat.sum(dim=1, keepdim=True)


def total_loss(outputs, gt: torch.Tensor, bin_weights: torch.Tensor,
               gt_orientation: torch.Tensor, *, weight_info_nce: float = 1e4,
               weight_ori: float = 1e1, global_mean=None):
    """The objective from the factored GT: ``gt`` [B, H, W] Gaussians,
    ``bin_weights`` [B, bins], ``gt_orientation`` [B, H, W, 2].

    Max-pooling commutes with the product by a sample's non-negative bin
    weights, so each scale's label is ``max_pool(gt, 2^k) ⊗ bin_weights``,
    the same values as pooling the dense binned volume.  Returns
    ``(loss, {"loss", "ce", "info_nce", "ori"})``.

    On one rank of a data-parallel step, ``global_mean`` (a tensor -> its
    mean over the ranks, no gradient) makes the normalizers the global
    batch's: the mean of the ranks' losses (what DDP's averaged gradients
    descend) is then the loss of the whole batch.  The cross-entropy and
    orientation terms are per-sample means and need nothing."""
    b = gt.shape[0]
    gt4 = gt.float()[..., None]
    w = bin_weights.float()[:, None, None, :]
    loss_ori = orientation_loss(outputs.ori.float(), gt_orientation.float(), gt4)
    labels = [(max_pool(gt4, 2 ** k) * w).reshape(b, -1) for k in POOL_EXPONENTS]
    return _assemble(outputs, _normalized_flat(gt4), loss_ori, labels,
                     weight_info_nce, weight_ori, global_mean)


def total_loss_binned(outputs, gt: torch.Tensor, gt_with_ori: torch.Tensor,
                      gt_orientation: torch.Tensor, *, weight_info_nce: float = 1e4,
                      weight_ori: float = 1e1):
    """The objective from the dense binned GT ``gt_with_ori`` [B, H, W, bins]
    and ``gt`` [B, H, W, 1]: the oracle ``total_loss`` is held to."""
    b = gt.shape[0]
    gt = gt.float()
    loss_ori = orientation_loss(outputs.ori.float(), gt_orientation.float(), gt)
    labels = [label.reshape(b, -1) for label in gt_pyramid(gt_with_ori.float())]
    return _assemble(outputs, _normalized_flat(gt), loss_ori, labels,
                     weight_info_nce, weight_ori)
