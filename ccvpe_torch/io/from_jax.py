"""Weights into the port: from the JAX package's parameter trees, and from
reference-format ``.pt`` checkpoints (and back out to them).

``state_dict_from_jax`` is the port's own copy of the layout rules of
``ccvpe_tpu/io/torch_import.py::export_cvm``:

* conv weight HWIO [kh, kw, I/g, O] -> OIHW [O, I/g, kh, kw];
* transposed-conv weight [I, 2, 2, O] -> [I, O, 2, 2];
* the satellite descriptor Linear: [(h, w, c) flat, D] -> [D, (c, h, w)
  flat], torch's flatten order of a [C, 2, 2] chunk;
* BatchNorm scale/bias/mean/var -> weight/bias/running_mean/running_var,
  plus ``num_batches_tracked`` = 0;
* the EfficientNet classifier head ``_fc`` (never run) as zeros.

The same rules name a JAX gradient tree, which has the shape of
``params``: ``grads_from_jax`` (parameters only: no BatchNorm buffers and
no ``_fc``, which the port trains without a gradient).

The trees are nested dicts and lists of array-likes (numpy arrays, or
anything ``np.asarray`` takes).

``import_b0`` puts a raw EfficientNet-B0 state_dict (the lukemelas release
file) into both encoders of a CVM, the counterpart of
``ccvpe_tpu/io/torch_import.py::import_b0`` in ``create_train_state``;
``check_shapes`` names the keys of a file that do not fit a model.
"""

from __future__ import annotations

import numpy as np
import torch

from ..nn.efficientnet import NUM_CLASSES


def _conv_w(w):
    return np.asarray(w).transpose(3, 2, 0, 1)


def _deconv_w(w):
    return np.asarray(w).transpose(0, 3, 1, 2)


def _bn(out, prefix, params, state):
    out[prefix + ".weight"] = np.asarray(params["scale"])
    out[prefix + ".bias"] = np.asarray(params["bias"])
    if state is None:
        return
    out[prefix + ".running_mean"] = np.asarray(state["mean"])
    out[prefix + ".running_var"] = np.asarray(state["var"])
    out[prefix + ".num_batches_tracked"] = np.zeros((), np.int64)


def _conv(out, prefix, p):
    out[prefix + ".weight"] = _conv_w(p["w"])
    if "b" in p:
        out[prefix + ".bias"] = np.asarray(p["b"])


def _backbone(out, p, params, state):
    """``state`` None: the parameters alone (no BN buffers, no ``_fc``)."""
    st = state or {"blocks": [{}] * len(params["blocks"])}
    _conv(out, p + "_conv_stem", params["conv_stem"])
    _bn(out, p + "_bn0", params["bn0"], st.get("bn0"))
    for i, (bp, bs) in enumerate(zip(params["blocks"], st["blocks"])):
        k = f"{p}_blocks.{i}."
        if "expand_conv" in bp:
            _conv(out, k + "_expand_conv", bp["expand_conv"])
            _bn(out, k + "_bn0", bp["bn0"], bs.get("bn0"))
        _conv(out, k + "_depthwise_conv", bp["depthwise_conv"])
        _bn(out, k + "_bn1", bp["bn1"], bs.get("bn1"))
        _conv(out, k + "_se_reduce", bp["se_reduce"])
        _conv(out, k + "_se_expand", bp["se_expand"])
        _conv(out, k + "_project_conv", bp["project_conv"])
        _bn(out, k + "_bn2", bp["bn2"], bs.get("bn2"))
    _conv(out, p + "_conv_head", params["conv_head"])
    _bn(out, p + "_bn1", params["bn1"], st.get("bn1"))
    if state is None:
        return
    feat = np.asarray(params["conv_head"]["w"]).shape[-1]
    out[p + "_fc.weight"] = np.zeros((NUM_CLASSES, feat), np.float32)
    out[p + "_fc.bias"] = np.zeros((NUM_CLASSES,), np.float32)


def _sat_linear(p, chunk_hw: int = 2):
    w = np.asarray(p["w"])  # [(h, w, c) flat, D]
    d = w.shape[1]
    chunk_c = w.shape[0] // (chunk_hw * chunk_hw)
    w = w.reshape(chunk_hw, chunk_hw, chunk_c, d)
    return w.transpose(3, 2, 0, 1).reshape(d, chunk_c * chunk_hw * chunk_hw)


def state_dict_from_jax(params, bn_state) -> dict[str, torch.Tensor]:
    """The JAX CVM's (params, bn_state) trees -> the port's state_dict
    (float leaves as float32 tensors)."""
    return _cvm_tensors(params, bn_state)


def grads_from_jax(grads) -> dict[str, torch.Tensor]:
    """A JAX CVM gradient tree (the shape of ``params``) -> float32 tensors
    under the port's parameter names, laid out as the port's ``.grad``s;
    BatchNorm buffers and the unused ``_fc`` heads are left out."""
    return _cvm_tensors(grads, None)


def _cvm_tensors(params, bn_state) -> dict[str, torch.Tensor]:
    out: dict[str, np.ndarray] = {}
    for name in ("grd_efficientnet", "sat_efficientnet"):
        _backbone(out, name + ".", params[name], None if bn_state is None else bn_state[name])
    for k in range(1, 7):
        name = f"grd_feature_to_descriptor{k}"
        _conv(out, f"{name}.0", params[name]["conv_c"])
        _conv(out, f"{name}.2", params[name]["conv_h"])
    out["sat_feature_to_descriptors.1.weight"] = _sat_linear(
        params["sat_feature_to_descriptors"])
    out["sat_feature_to_descriptors.1.bias"] = np.asarray(
        params["sat_feature_to_descriptors"]["b"])
    for k in range(1, 7):
        for suffix in ("", "_ori"):
            dp = params[f"deconv{k}{suffix}"]
            out[f"deconv{k}{suffix}.weight"] = _deconv_w(dp["w"])
            out[f"deconv{k}{suffix}.bias"] = np.asarray(dp["b"])
            cp = params[f"conv{k}{suffix}"]
            _conv(out, f"conv{k}{suffix}.0", cp["conv_a"])
            _conv(out, f"conv{k}{suffix}.2", cp["conv_b"])
    return {k: torch.from_numpy(np.ascontiguousarray(
                v if np.issubdtype(v.dtype, np.integer) else v.astype(np.float32)))
            for k, v in out.items()}


def check_shapes(want: dict, have: dict, spec, preset: str) -> None:
    """Raise ``ValueError`` naming the first keys whose shapes differ
    between a model's state_dict (``want``) and a file's (``have``), a key
    missing on one side included (JAX ``train/loop.py::_check_encoder_shapes``)."""
    def shape(d, k):
        return tuple(d[k].shape) if k in d else None

    bad = [f"{k}: model wants {shape(want, k)} but file has {shape(have, k)}"
           for k in sorted(set(want) | set(have)) if shape(want, k) != shape(have, k)]
    if bad:
        raise ValueError(
            f"pretrained weights {spec!r} do not match the configured encoder "
            f"(preset {preset!r}): " + "; ".join(bad[:3])
            + (f"; … {len(bad) - 3} more" if len(bad) > 3 else ""))


def import_b0(model: torch.nn.Module, state_dict: dict, spec="") -> None:
    """Load a raw EfficientNet-B0 state_dict into ``model``'s ground and
    satellite encoders, weights and BN statistics; the classifier head
    ``_fc.*`` is left as it is (unused, as ``load_fc=False``) and
    ``num_batches_tracked`` is the model's own.  ``spec`` names the file in
    the error raised when its shapes do not fit the model's preset."""
    def tensors(sd):
        return {k: v for k, v in sd.items()
                if not k.startswith("_fc.") and not k.endswith("num_batches_tracked")}

    have = tensors(state_dict)
    for name in ("grd_efficientnet", "sat_efficientnet"):
        encoder = getattr(model, name)
        check_shapes(tensors(encoder.state_dict()), have, spec, model.cfg.name)
        encoder.load_state_dict(have, strict=False)


def load_state_dict(path) -> dict[str, torch.Tensor]:
    """Read a reference-format ``.pt`` checkpoint (``torch.save`` of a
    state_dict) onto the CPU."""
    return torch.load(path, map_location="cpu", weights_only=True)


def save_state_dict(module: torch.nn.Module, path) -> None:
    """Write ``module``'s state_dict as a reference-format ``.pt``: contiguous
    CPU tensors under the reference's key names, floats in float32 (also
    from bfloat16 parameters, exactly, as the JAX export casts them),
    readable by ``load_state_dict`` here and
    ``ccvpe_tpu.io.torch_import.load_state_dict`` (JAX
    ``io/torch_import.py::save_torch_checkpoint``)."""
    torch.save({k: (v.float() if v.is_floating_point() else v).detach().cpu().contiguous()
                for k, v in module.state_dict().items()}, path)
