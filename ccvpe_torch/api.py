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
post-training-quantized form.  ``load_model(..., mesh="data")`` serves
from one replica per visible CUDA device (``predict_batch`` splits the
batch over them).

``export_model(model, "export/")`` writes the pose forward as a
``torch.export`` program with its weights; ``load_exported("export/")``
serves it without the model code (this module imports the model only
where it builds or exports one):

    api.export_model(model, "export/", batch="dynamic")
    poses = api.load_exported("export/").predict_batch(grd, sat)
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

import numpy as np
import torch

from . import resolve_device
from .data.transforms import normalize_images
from .train.metrics import angle_from_cos_sin
from .utils.profiling import annotate

if TYPE_CHECKING:
    from .models import cvm


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


def _offsets(ori_noise: float):
    """The localization branch's bin offsets: None (all bins) or the
    prior's ``range(-n, n + 1)``."""
    n = _ori_noise_to_n(ori_noise)
    return None if n is None else range(-n, n + 1)


def _poses_from_readout(r: dict[str, np.ndarray], batch: int,
                        return_heatmap: bool) -> list[Pose]:
    """``Pose``s from a readout's host arrays (``ops.readout.pose_readout``)."""
    poses = []
    for i in range(batch):
        ang, valid = angle_from_cos_sin(r["cos"][i], r["sin"][i])
        poses.append(Pose(
            row=int(r["row"][i]), col=int(r["col"][i]),
            orientation_deg=float(ang) if valid else float("nan"),
            probability=float(r["prob"][i]),
            heatmap=r["heatmap"][i] if return_heatmap else None))
    return poses


def mesh_devices(mesh) -> list[torch.device]:
    """The devices of a serving mesh: ``"data"`` is every visible CUDA
    device; a list names them (one replica each, a device may repeat)."""
    if mesh == "data":
        if not torch.cuda.is_available():
            raise RuntimeError("mesh='data' places one replica per CUDA device and none is "
                               "available; pass a list of devices")
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [resolve_device(d) for d in mesh]
    if not devices:
        raise ValueError("a serving mesh needs at least one device")
    return devices


class CVMModel:
    def __init__(self, cfg: cvm.CVMConfig, net: cvm.CVM, device: torch.device,
                 matching_impl: str = "kernel", mesh=None):
        """``net`` in eval mode on ``device``.  ``matching_impl``: 'kernel'
        (the CUDA kernels on a CUDA device) or 'plain' (their plain
        PyTorch versions).

        ``mesh`` (JAX ``mesh=``): ``"data"`` or a list of devices -- one
        replica of ``net`` per device (``net`` itself is the first, on the
        first device).  ``predict_batch`` splits a batch that the replica
        count divides into contiguous slices, one per replica, and joins
        the readouts in order; any other batch runs on the first replica,
        as JAX falls back to replicated placement."""
        self.cfg = cfg
        self.matching_impl = matching_impl
        self.mesh = None if mesh is None else mesh_devices(mesh)
        if self.mesh is not None:
            from .parallel.mesh import replicate

            nets = replicate(net, self.mesh)
            net, device = nets[0], self.mesh[0]
            self.replicas = [self] + [CVMModel(cfg, n, d, matching_impl)
                                      for n, d in zip(nets[1:], self.mesh[1:])]
        else:
            self.replicas = [self]
        self.net = net
        self.device = device

    def forward_readout(self, grd: np.ndarray, sat: np.ndarray, *,
                        ori_noise: float = 180.0, fov: float = 360.0,
                        return_heatmap: bool = False
                        ) -> tuple[cvm.CVMOutputs, dict[str, torch.Tensor]]:
        """The forward and the on-device readout of ``predict_batch``."""
        from .ops.readout import pose_readout

        circular = None
        if fov < 360:
            # limited field of view: the leading fov/360 of the panorama,
            # encoded without circular padding (its input no longer wraps)
            w = int(grd.shape[2] * fov / 360) if (
                grd.shape[2] == self.cfg.grd_hw[1]) else grd.shape[2]
            grd = grd[:, :, :w]
            circular = False
        with torch.inference_mode():
            with annotate("predict.upload"):
                grd, sat = self._normalized(grd), self._normalized(sat)
            with annotate("predict.forward"):
                out = self.net(grd, sat, loc_offsets=_offsets(ori_noise), circular=circular,
                               matching_impl=self.matching_impl)
                return out, pose_readout(out, want_heatmap=return_heatmap)

    def predict_batch(self, grd: np.ndarray, sat: np.ndarray, *,
                      ori_noise: float = 180.0, fov: float = 360.0,
                      return_heatmap: bool = False) -> list[Pose]:
        """grd [B, H, W, 3] uint8 (model-sized), sat [B, H, W, 3] uint8.

        ``fov < 360`` crops the panorama to its leading ``fov/360`` width
        and turns the ground encoder's circular padding off.  Under a
        profiler a call shows as the spans ``predict.upload`` and
        ``predict.forward`` (one each per replica), ``predict.fetch`` (the
        call's one wait for the device) and ``predict.poses``."""
        n = len(self.replicas)
        kw = dict(ori_noise=ori_noise, fov=fov, return_heatmap=return_heatmap)
        if n > 1 and grd.shape[0] % n == 0:
            # every replica's forward is issued before any readout is fetched
            rs = [rep.forward_readout(g, s, **kw)[1] for rep, g, s in
                  zip(self.replicas, np.split(grd, n), np.split(sat, n))]
            with annotate("predict.fetch"):
                r = {k: np.concatenate([ri[k].cpu().numpy() for ri in rs]) for k in rs[0]}
        else:
            _, r = self.forward_readout(grd, sat, **kw)
            with annotate("predict.fetch"):
                r = {k: v.cpu().numpy() for k, v in r.items()}
        with annotate("predict.poses"):
            return _poses_from_readout(r, grd.shape[0], return_heatmap)

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
        offsets = _offsets(ori_noise)

        def forward(g, s):
            return self.net(self._normalized(g), self._normalized(s), loc_offsets=offsets,
                            matching_impl=self.matching_impl)

        with torch.inference_mode():
            ranges = quant.calibrate(self.net, calib, forward)
        quant.quantize_params(self.net, ranges, select=policy)
        if self.mesh is not None:
            # every replica the same int8 model (JAX: the quantized tree replicated)
            from .parallel.mesh import replicate

            for rep, net in zip(self.replicas[1:], replicate(self.net, self.mesh)[1:]):
                rep.net = net
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


EXPORT_MAX_BATCH = 4096   # the upper end of an exported program's symbolic batch


class _PoseForward(torch.nn.Module):
    """What an export holds: ImageNet-normalised NHWC images -> the pose
    readout with the heatmap (``ops.readout.pose_readout``), the matching
    through its plain versions."""

    def __init__(self, net: torch.nn.Module, offsets):
        super().__init__()
        self.net = net
        self.offsets = offsets

    def forward(self, grd: torch.Tensor, sat: torch.Tensor) -> dict[str, torch.Tensor]:
        from .ops.readout import pose_readout

        out = self.net(grd, sat, loc_offsets=self.offsets, matching_impl="plain")
        return pose_readout(out, want_heatmap=True)


def _export_file(path: str, device: torch.device) -> str:
    return os.path.join(path, f"forward.{device.type}.pt2")


def export_model(model: CVMModel, path: str, *, batch: int | str = 1,
                 ori_noise: float = 180.0, platforms: Sequence[str] | None = None) -> None:
    """Serialize the pose forward for deployment (JAX ``export_model``).

    Writes to the directory ``path`` one ``torch.export`` program per
    device, ``forward.<device>.pt2`` (``torch.export.save``; the weights are
    inside it), and ``meta.json`` (``preset_grd_hw``, ``preset_sat_hw``,
    ``batch``, ``ori_noise``).  The program takes the normalised images and
    returns the readout with the heatmap; ``load_exported`` serves it
    without this package's model code.

    ``batch``: a fixed batch size, or ``"dynamic"`` for a symbolic batch
    dimension (1 to ``EXPORT_MAX_BATCH``; traced at batch 2, since
    ``torch.export`` specializes sizes 0 and 1).  ``platforms``: the devices
    to export for, e.g. ``("cpu", "cuda")`` (JAX lowers one artifact for
    several platforms; a ``torch.export`` program holds the device of every
    tensor it makes, so each device gets its own file); default the model's.

    The export always traces the plain matching, as JAX's always lowers its
    einsum: the kernels' ctypes launches cannot be traced.  Its numbers are
    those of ``CVMModel(matching_impl="plain").predict_batch``.  An int8
    model exports its int8 forward; on the card its ``torch._int_mm``
    product pads the rows to the product's limits from the batch, so an int8
    model exports at a fixed batch there.
    """
    import copy
    import warnings

    devices = ([model.device] if platforms is None
               else [resolve_device(p) for p in platforms])
    dynamic = batch == "dynamic"
    b = 2 if dynamic else int(batch)
    dims = None
    if dynamic:
        dim = torch.export.Dim("batch", min=1, max=EXPORT_MAX_BATCH)
        dims = {"grd": {0: dim}, "sat": {0: dim}}
    os.makedirs(path, exist_ok=True)
    for device in devices:
        net = model.net if device == model.device else copy.deepcopy(model.net).to(device)
        example = tuple(torch.zeros((b, *hw, 3), device=device)
                        for hw in (model.cfg.grd_hw, model.cfg.sat_hw))
        with torch.no_grad():
            program = torch.export.export(_PoseForward(net, _offsets(ori_noise)), example,
                                          dynamic_shapes=dims)
        with warnings.catch_warnings():
            # the archive calls a channels_last weight "not complete" (not
            # contiguous) and writes its storage whole, with its strides
            warnings.filterwarnings("ignore", "No complete tensor found in the group")
            torch.export.save(program, _export_file(path, device))
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump({"preset_grd_hw": list(model.cfg.grd_hw),
                   "preset_sat_hw": list(model.cfg.sat_hw),
                   "batch": batch, "ori_noise": ori_noise}, f)


class ExportedModel:
    """A deserialized export on ``device`` (default ``cuda``): pose
    inference from the program alone, no model code."""

    def __init__(self, path: str, device: str | torch.device | None = None):
        self.device = resolve_device(device)
        with open(os.path.join(path, "meta.json")) as f:
            self.meta = json.load(f)
        file = _export_file(path, self.device)
        if not os.path.exists(file):
            have = sorted(n for n in os.listdir(path) if n.endswith(".pt2"))
            raise FileNotFoundError(f"{file} not found: this export holds {have}; "
                                    f"re-export with platforms=('{self.device.type}',)")
        self._forward = torch.export.load(file).module()

    def predict_batch(self, grd: np.ndarray, sat: np.ndarray, *,
                      return_heatmap: bool = False) -> list[Pose]:
        want = self.meta["batch"]
        if want != "dynamic" and grd.shape[0] != want:
            raise ValueError(
                f"this export is fixed to batch={want}; "
                f"got {grd.shape[0]} images (re-export with batch="
                f"{grd.shape[0]} or batch='dynamic', or pad the batch)")
        g, s = (normalize_images(torch.from_numpy(np.ascontiguousarray(x)).to(self.device))
                for x in (grd, sat))
        with torch.inference_mode():
            r = self._forward(g, s)
        r = {k: v.cpu().numpy() for k, v in r.items()}
        return _poses_from_readout(r, grd.shape[0], return_heatmap)


def load_exported(path: str, device: str | torch.device | None = None) -> ExportedModel:
    """Load a directory written by ``export_model`` onto ``device``
    (default ``cuda``; raises when CUDA is absent and no device was asked
    for)."""
    return ExportedModel(path, device)


def load_model(checkpoint_path: str | None = None, preset: str = "VIGOR",
               seed: int = 0, device: str | torch.device | None = None,
               matching_impl: str = "kernel", mesh=None) -> CVMModel:
    """A model from a reference-format ``.pt`` checkpoint, from the newest
    step of a training checkpoint directory (``io.checkpoint``; float32 or
    bfloat16 parameters), or seeded random weights
    (``checkpoint_path=None``), on ``device`` (default ``cuda``; raises when
    CUDA is absent and no device was asked for).

    The model runs in float32: bfloat16 parameters are read into float32
    exactly, which is what the JAX model does when it casts them to its
    float32 inputs at each op.  ``matching_impl``: 'kernel' (the CUDA
    kernels on a CUDA device) or 'plain'.  ``mesh``: ``"data"`` or a list
    of devices, one replica each (``CVMModel``); it takes the place of
    ``device``."""
    from .models import cvm

    device = mesh_devices(mesh)[0] if mesh is not None else resolve_device(device)
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
    return CVMModel(cfg, net, device, matching_impl=matching_impl, mesh=mesh)
