"""High-level inference API of the port (counterpart of ``ccvpe_tpu/api.py``):

    from ccvpe_torch import api
    model = api.load_model("model.pt", preset="VIGOR")      # on cuda
    model = api.load_model("checkpoints/", preset="VIGOR")  # a trainer's newest step
    pose = model.predict(grd_image, sat_image, ori_noise=36.0)
    pose.row, pose.col, pose.orientation_deg, pose.probability

Images are uint8 RGB arrays (HWC); ``predict`` resizes them on the host,
``predict_batch`` takes model-sized batches.  Normalisation, the forward and
the pose readout run on the model's device under ``torch.inference_mode``.
``model.quantize_int8(calib)`` turns a serving model into its int8
post-training-quantized form.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from . import resolve_device
from .data.transforms import normalize_images
from .models import cvm
from .ops.readout import pose_readout
from .train.metrics import angle_from_cos_sin


@dataclass
class Pose:
    row: int                 # heatmap argmax (pixels, aerial frame)
    col: int
    orientation_deg: float   # heading from north (reference convention)
    probability: float       # heatmap mass at the estimated location
    heatmap: np.ndarray | None = None   # [H, W] if return_heatmap


def _ori_noise_to_n(ori_noise: float) -> int | None:
    """Prior of +-n bins of 18 degrees; None = unknown orientation (all bins)."""
    if ori_noise >= 180:
        return None
    return int(ori_noise // 18)


class CVMModel:
    def __init__(self, cfg: cvm.CVMConfig, net: cvm.CVM, device: torch.device,
                 matching_impl: str = "kernel"):
        """``net`` in eval mode on ``device``.  ``matching_impl``: 'kernel'
        (the CUDA kernels on a CUDA device) or 'plain' (their plain
        PyTorch versions)."""
        self.cfg = cfg
        self.net = net
        self.device = device
        self.matching_impl = matching_impl

    def forward_readout(self, grd: np.ndarray, sat: np.ndarray, *,
                        ori_noise: float = 180.0, fov: float = 360.0,
                        return_heatmap: bool = False
                        ) -> tuple[cvm.CVMOutputs, dict[str, torch.Tensor]]:
        """The forward and the on-device readout of ``predict_batch``."""
        circular = None
        if fov < 360:
            # limited field of view: the leading fov/360 of the panorama,
            # encoded without circular padding (its input no longer wraps)
            w = int(grd.shape[2] * fov / 360) if (
                grd.shape[2] == self.cfg.grd_hw[1]) else grd.shape[2]
            grd = grd[:, :, :w]
            circular = False
        n = _ori_noise_to_n(ori_noise)
        offsets = None if n is None else range(-n, n + 1)
        with torch.inference_mode():
            out = self.net(self._normalized(grd), self._normalized(sat), loc_offsets=offsets,
                           circular=circular, matching_impl=self.matching_impl)
            return out, pose_readout(out, want_heatmap=return_heatmap)

    def predict_batch(self, grd: np.ndarray, sat: np.ndarray, *,
                      ori_noise: float = 180.0, fov: float = 360.0,
                      return_heatmap: bool = False) -> list[Pose]:
        """grd [B, H, W, 3] uint8 (model-sized), sat [B, H, W, 3] uint8.

        ``fov < 360`` crops the panorama to its leading ``fov/360`` width
        and turns the ground encoder's circular padding off."""
        _, r = self.forward_readout(grd, sat, ori_noise=ori_noise, fov=fov,
                                    return_heatmap=return_heatmap)
        r = {k: v.cpu().numpy() for k, v in r.items()}
        poses = []
        for i in range(grd.shape[0]):
            ang, valid = angle_from_cos_sin(r["cos"][i], r["sin"][i])
            poses.append(Pose(
                row=int(r["row"][i]), col=int(r["col"][i]),
                orientation_deg=float(ang) if valid else float("nan"),
                probability=float(r["prob"][i]),
                heatmap=r["heatmap"][i] if return_heatmap else None))
        return poses

    def quantize_int8(self, calib: Sequence[tuple] | None = None, *,
                      ori_noise: float = 180.0, select: str = "all") -> "CVMModel":
        """Post-training int8 quantization of this model, in place (JAX
        ``CVMModel.quantize_int8``).

        Swaps the selected convs for ``nn.layers.QuantConv2d``: per-channel
        int8 weights and calibrated static activation scales (``nn.quant``).
        Later ``predict`` / ``predict_batch`` calls run them as int8
        products (``torch._int_mm`` on the card) with int32 sums; the
        matching (K1, K2 on the card), the deconvs and the descriptor
        collapse and matmul stay in float32.  The model stays on its device.
        Inference-only: ``save_torch`` refuses the int8 model (the reference
        checkpoint format has no int8 form), so quantize a serving copy.

        ``calib``: (grd, sat) uint8 image batches at model size whose
        forwards (at ``ori_noise``'s offsets) record the activation ranges;
        default one seeded batch of two uniform-noise pairs (prefer a
        handful of real samples for deployment).  ``select``: ``"all"``
        (every non-depthwise conv) or ``"mxu"``/``"mxu:<threshold>"``
        (``nn.quant.mxu_bound_select``)."""
        from .nn import quant

        if quant.quantized_fraction(self.net) > 0:
            raise ValueError(
                "model is already int8-quantized; re-quantizing would "
                "recalibrate on int8 codes and corrupt the scales")
        policy = quant.resolve_select(select)
        if calib is None:
            rng = np.random.default_rng(0)
            calib = [(rng.integers(0, 256, (2, *self.cfg.grd_hw, 3), dtype=np.uint8),
                      rng.integers(0, 256, (2, *self.cfg.sat_hw, 3), dtype=np.uint8))]
        n = _ori_noise_to_n(ori_noise)
        offsets = None if n is None else range(-n, n + 1)

        def forward(g, s):
            return self.net(self._normalized(g), self._normalized(s), loc_offsets=offsets,
                            matching_impl=self.matching_impl)

        with torch.inference_mode():
            ranges = quant.calibrate(self.net, calib, forward)
        quant.quantize_params(self.net, ranges, select=policy)
        return self

    def _normalized(self, images: np.ndarray) -> torch.Tensor:
        return normalize_images(torch.from_numpy(np.ascontiguousarray(images)).to(self.device))

    def save_torch(self, path: str) -> None:
        """Write a reference-format ``.pt`` of this model's weights and BN
        statistics (``io.from_jax.save_state_dict``; JAX ``api.py:233``)."""
        from .io.from_jax import save_state_dict
        from .nn.quant import quantized_fraction

        if quantized_fraction(self.net) > 0:
            raise ValueError(
                "cannot write an int8-quantized model to a torch "
                "checkpoint — quantized models are inference-only; keep the "
                "float model for torch export (see quantize_int8 docstring)")
        save_state_dict(self.net, path)

    def predict(self, grd: np.ndarray, sat: np.ndarray, *,
                ori_noise: float = 180.0, fov: float = 360.0,
                return_heatmap: bool = False) -> Pose:
        """One ground/aerial pair at any size (PIL-bilinear resized on the
        host); with ``fov < 360`` the resized panorama is cropped."""
        grd = _prepare(grd, self.cfg.grd_hw)
        sat = _prepare(sat, self.cfg.sat_hw)
        return self.predict_batch(grd[None], sat[None], ori_noise=ori_noise,
                                  fov=fov, return_heatmap=return_heatmap)[0]


def _prepare(img: np.ndarray, hw) -> np.ndarray:
    img = np.asarray(img, np.uint8)
    if img.shape[:2] != tuple(hw):
        from PIL import Image

        img = np.asarray(Image.fromarray(img).resize((hw[1], hw[0]), Image.BILINEAR))
    return img


def load_model(checkpoint_path: str | None = None, preset: str = "VIGOR",
               seed: int = 0, device: str | torch.device | None = None,
               matching_impl: str = "kernel") -> CVMModel:
    """A model from a reference-format ``.pt`` checkpoint, from the newest
    step of a training checkpoint directory (``io.checkpoint``; float32 or
    bfloat16 parameters), or seeded random weights
    (``checkpoint_path=None``), on ``device`` (default ``cuda``; raises when
    CUDA is absent and no device was asked for).

    The model runs in float32: bfloat16 parameters are read into float32
    exactly, which is what the JAX model does when it casts them to its
    float32 inputs at each op.  ``matching_impl``: 'kernel' (the CUDA
    kernels on a CUDA device) or 'plain'."""
    device = resolve_device(device)
    cfg = cvm.PRESETS[preset]
    net = cvm.CVM(cfg)
    if checkpoint_path is None:
        net.init_weights_(torch.Generator().manual_seed(seed))
    elif str(checkpoint_path).endswith(".pt"):
        from .io.from_jax import load_state_dict

        net.load_state_dict(load_state_dict(checkpoint_path), strict=True)
    elif os.path.isdir(checkpoint_path):
        from .io.checkpoint import CheckpointManager
        from .io.from_jax import check_shapes

        weights = CheckpointManager(checkpoint_path).load_weights()
        check_shapes(net.state_dict(), weights, checkpoint_path, cfg.name)
        net.load_state_dict(weights, strict=True)
    else:
        raise ValueError(f"expected a .pt checkpoint or a checkpoint directory, "
                         f"got {checkpoint_path!r}")
    net = net.eval().to(device=device, memory_format=torch.channels_last)
    return CVMModel(cfg, net, device, matching_impl=matching_impl)
