"""Core NN layers of the port (counterpart of ``ccvpe_tpu/nn/layers.py``).

Modules take NCHW tensors, as PyTorch's do; the model keeps them in
``channels_last`` memory.  Semantics carried over from the reference:

* TF-style "SAME" pads computed from the *construction-time* 224-px trace,
  not from the runtime input, and possibly asymmetric.  They are applied
  with ``F.pad`` in front of a ``padding=0`` conv.
* Horizontal circular ("wrap") padding then vertical zeros for panoramas.
* BatchNorm with eps 1e-3 and torch's momentum 0.01.  In train mode
  ``nn.BatchNorm2d`` normalises with the biased batch variance and folds
  the unbiased one (n = B*H*W) into the running variance, as ``bn_apply``
  does.
* ``ConvTranspose2d(k=2, s=2)`` for the decoder's upsampling.
* Stochastic depth (``drop_connect``) with a per-sample uniform draw.

The dtype follows the input, as in the JAX package: every conv, deconv and
linear layer casts its weight and bias to ``x.dtype`` at the op, and
``BatchNorm2d`` casts its terms.  In float32 (and for float32 weights)
nothing is cast and the layers are ``torch.nn``'s own.  For a bfloat16
input BatchNorm follows ``bn_apply`` op by op: batch statistics from the
bfloat16 activations (summed in float32, rounded to bfloat16), folded into
float32 running statistics; the normalisation in bfloat16.

``QuantConv2d`` is the int8 conv of post-training quantization
(``nn/quant.py``; JAX ``_conv_apply_int8``), with JAX's op order and
rounding: the same codes and int32 sums from the same inputs.

``checkpoint`` is the rematerialisation of a block (``jax.checkpoint``):
``torch.utils.checkpoint`` without re-entry, whose recompute neither folds
the batch statistics into the running ones a second time nor draws new
drop-connect bits from the caller's generator.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

Pad2d = tuple[tuple[int, int], tuple[int, int]]

NO_PAD: Pad2d = ((0, 0), (0, 0))

BN_EPS = 1e-3
BN_MOMENTUM = 0.01

silu = F.silu


def same_pad(traced_hw: tuple[int, int], kernel: int, stride: int,
             dilation: int = 1) -> Pad2d:
    """TF 'SAME' pad amounts ((top, bottom), (left, right)) for a traced image size."""
    ih, iw = traced_hw
    oh, ow = math.ceil(ih / stride), math.ceil(iw / stride)
    pad_h = max((oh - 1) * stride + (kernel - 1) * dilation + 1 - ih, 0)
    pad_w = max((ow - 1) * stride + (kernel - 1) * dilation + 1 - iw, 0)
    return ((pad_h // 2, pad_h - pad_h // 2), (pad_w // 2, pad_w - pad_w // 2))


def traced_output_hw(traced_hw: tuple[int, int], stride: int) -> tuple[int, int]:
    """Construction-time image-size bookkeeping of a strided layer."""
    ih, iw = traced_hw
    return (math.ceil(ih / stride), math.ceil(iw / stride))


def pad2d(x: torch.Tensor, pad: Pad2d, circular: bool = False) -> torch.Tensor:
    """Pad an NCHW tensor; horizontal wrap first, then vertical zeros, when
    ``circular``."""
    (pt, pb), (pl, pr) = pad
    if circular and (pl or pr):
        x = torch.cat([x[..., x.shape[-1] - pl:], x, x[..., :pr]], dim=-1)
        pl = pr = 0
    if pt or pb or pl or pr:
        x = F.pad(x, (pl, pr, pt, pb))
    return x


class ConvSpec(NamedTuple):
    """Static configuration of one conv layer (shapes and pads are build-time)."""

    cin: int
    cout: int
    kernel: int
    stride: int = 1
    groups: int = 1
    bias: bool = False
    pad: Pad2d = NO_PAD
    circular: bool = False


def _like(p: torch.Tensor | None, x: torch.Tensor) -> torch.Tensor | None:
    """A weight or bias in the input's dtype (itself when it already is)."""
    return None if p is None else p.to(x.dtype)


def _fused_bias(x: torch.Tensor) -> bool:
    """float32 keeps torch's fused bias; another dtype adds the bias after
    the op, as the JAX layers do (its gradient then sums in float32)."""
    return x.dtype == torch.float32


def _add_bias(y: torch.Tensor, bias: torch.Tensor | None, channel_dim: int) -> torch.Tensor:
    if bias is None:
        return y
    shape = [1] * y.dim()
    shape[channel_dim] = -1
    return y + bias.to(y.dtype).view(shape)


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` whose weight and bias take the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _fused_bias(x):
            return self._conv_forward(x, _like(self.weight, x), _like(self.bias, x))
        return _add_bias(self._conv_forward(x, _like(self.weight, x), None), self.bias, 1)


class ConvTranspose2d(nn.ConvTranspose2d):
    """``nn.ConvTranspose2d`` whose weight and bias take the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        fused = _fused_bias(x)
        y = F.conv_transpose2d(x, _like(self.weight, x), _like(self.bias, x) if fused else None,
                               self.stride, self.padding, self.output_padding, self.groups,
                               self.dilation)
        return y if fused else _add_bias(y, self.bias, 1)


class Linear(nn.Linear):
    """``nn.Linear`` whose weight and bias take the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if _fused_bias(x):
            return F.linear(x, _like(self.weight, x), _like(self.bias, x))
        return _add_bias(F.linear(x, _like(self.weight, x)), self.bias, -1)


class StaticPadConv2d(Conv2d):
    """``Conv2d`` with padding 0 behind a build-time static (TF-SAME,
    optionally circular) pad.  State-dict keys: ``weight`` and ``bias``."""

    def __init__(self, spec: ConvSpec):
        super().__init__(spec.cin, spec.cout, spec.kernel, stride=spec.stride,
                         padding=0, groups=spec.groups, bias=spec.bias)
        self.static_pad = spec.pad
        self.circular = spec.circular

    def forward(self, x: torch.Tensor, circular: bool | None = None) -> torch.Tensor:
        circular = self.circular if circular is None else circular
        return super().forward(pad2d(x, self.static_pad, circular))


# int8 products of QuantConv2d by route: 'mm' (torch._int_mm, on the card)
# and 'plain' (the exact float64 conv, on the CPU); reset with reset_int8_counts
INT8_COUNTS = {"mm": 0, "plain": 0}
_INT8_LOCK = threading.Lock()
# torch._int_mm on CUDA takes more than 16 rows, and K and N in multiples of 8
_MM_MIN_ROWS, _MM_ALIGN = 17, 8


def reset_int8_counts() -> None:
    with _INT8_LOCK:
        for k in INT8_COUNTS:
            INT8_COUNTS[k] = 0


def int8_counts() -> dict:
    with _INT8_LOCK:
        return dict(INT8_COUNTS)


def _count_int8(route: str) -> None:
    with _INT8_LOCK:
        INT8_COUNTS[route] += 1


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def quantize_activation(x_nhwc: torch.Tensor, inv_sx: torch.Tensor) -> torch.Tensor:
    """int8 codes ``clip(round(x * inv_sx), -127, 127)`` in float32 (ties to
    even), laid out NHWC-contiguous."""
    xq = torch.clamp(torch.round(x_nhwc.float() * inv_sx), -127.0, 127.0)
    return xq.to(torch.int8).contiguous()


def pad_nhwc(x: torch.Tensor, pad: Pad2d, circular: bool = False) -> torch.Tensor:
    """``pad2d`` on an NHWC tensor (of any dtype): wrap first, then zeros."""
    (pt, pb), (pl, pr) = pad
    if circular and (pl or pr):
        x = torch.cat([x[:, :, x.shape[2] - pl:], x, x[:, :, :pr]], dim=2)
        pl = pr = 0
    if pt or pb or pl or pr:
        x = F.pad(x, (0, 0, pl, pr, pt, pb))
    return x.contiguous()


def int8_weight_matrix(weight: torch.Tensor) -> torch.Tensor:
    """OIHW int8 codes -> the [N, K] operand of ``int8_conv_mm``: rows in
    (kh, kw, c) order, N and K zero-padded to multiples of 8."""
    o = weight.shape[0]
    w = weight.permute(0, 2, 3, 1).reshape(o, -1)
    n, k = _round_up(o, _MM_ALIGN), _round_up(w.shape[1], _MM_ALIGN)
    return F.pad(w, (0, k - w.shape[1], 0, n - o)).contiguous()


def int8_conv_mm(xq: torch.Tensor, w_mat: torch.Tensor, kernel: int, stride: int,
                 cout: int) -> torch.Tensor:
    """int32 accumulators [B, Ho, Wo, cout] of a conv of the padded NHWC int8
    map ``xq`` with the codes of ``w_mat`` (``int8_weight_matrix``): an int8
    im2col times the weights through ``torch._int_mm`` (cuBLASLt int8 on the
    tensor cores, int32 sums).  The im2col's rows, K and N are zero-padded to
    the product's limits, which is exact in integers.  A 1x1 stride-1 conv
    whose K needs no padding reads the map itself."""
    b, hp, wp, c = xq.shape
    ho, wo = (hp - kernel) // stride + 1, (wp - kernel) // stride + 1
    m = b * ho * wo
    n_pad, k_pad = w_mat.shape
    m_pad = m if m >= _MM_MIN_ROWS else _round_up(_MM_MIN_ROWS, 16)
    if kernel == stride == 1 and k_pad == c and m_pad == m:
        cols = xq.reshape(m, c)
    else:
        alloc = torch.empty if (k_pad, m_pad) == (kernel * kernel * c, m) else torch.zeros
        cols = alloc((m_pad, k_pad), dtype=torch.int8, device=xq.device)
        patches = xq.unfold(1, kernel, stride).unfold(2, kernel, stride)  # [B,Ho,Wo,C,kh,kw]
        torch.as_strided(cols, (b, ho, wo, kernel, kernel, c),
                         (ho * wo * k_pad, wo * k_pad, k_pad, kernel * c, c, 1)
                         ).copy_(patches.permute(0, 1, 2, 4, 5, 3))
    acc = torch._int_mm(cols, w_mat.t())
    return acc[:m, :cout].view(b, ho, wo, cout)


def int8_conv_plain(xq: torch.Tensor, weight: torch.Tensor, stride: int) -> torch.Tensor:
    """The plain version of ``int8_conv_mm``: the same integers through a
    float64 conv, exact (every partial sum is an integer far below 2**53)."""
    y = F.conv2d(xq.permute(0, 3, 1, 2).double(), weight.double(), stride=stride)
    return y.to(torch.int32).permute(0, 2, 3, 1)


class QuantConv2d(nn.Module):
    """Post-training int8 conv (JAX ``layers._conv_apply_int8``): int8
    activations with the calibrated per-tensor scale ``q_sx``, int8 weights
    with per-output-channel scales ``q_sw``, int32 sums, then
    ``(acc * (q_sx * q_sw)).to(x.dtype) + bias`` (the bias after, in
    ``x.dtype``).  The map is quantized before it is padded: zero and wrap
    padding are exact on the codes.

    It keeps the source conv's pads: a ``StaticPadConv2d``'s static pad and
    circular flag (with the per-call ``circular`` override), or the
    decoder's symmetric ``Conv2d(padding=p)``.  Buffers (state-dict keys):
    ``weight`` (int8 OIHW), ``q_sw``, ``q_sx``, ``bias``.  On a CUDA tensor
    the product is ``int8_conv_mm``; on a CPU tensor ``int8_conv_plain``; on
    any other device it raises.  Inference only."""

    def __init__(self, conv: nn.Conv2d, weight: torch.Tensor, q_sw: torch.Tensor,
                 q_sx: torch.Tensor, bias: torch.Tensor | None = None):
        super().__init__()
        if conv.groups != 1 or conv.dilation != (1, 1) or len(set(conv.stride)) != 1:
            raise ValueError(f"the int8 conv takes ungrouped, undilated, square-strided "
                             f"convs, not {conv}")
        if isinstance(conv, StaticPadConv2d):
            self.static_pad, self.circular = conv.static_pad, conv.circular
        else:
            ph, pw = conv.padding
            self.static_pad, self.circular = ((ph, ph), (pw, pw)), False
        self.kernel, self.stride = conv.kernel_size[0], conv.stride[0]
        self.register_buffer("weight", weight.to(torch.int8))
        self.register_buffer("q_sw", q_sw.to(torch.float32))
        self.register_buffer("q_sx", q_sx.to(torch.float32).reshape(()))
        self.register_buffer("bias", None if bias is None else bias.detach().clone())
        self._derive()

    def _derive(self) -> None:
        """The buffers that follow from the codes and scales: 1 / q_sx and
        q_sx * q_sw in float32, and the product's weight operand."""
        self.register_buffer("inv_sx", torch.ones_like(self.q_sx) / self.q_sx,
                             persistent=False)
        self.register_buffer("scale", self.q_sx * self.q_sw, persistent=False)
        self.register_buffer("w_mat", int8_weight_matrix(self.weight), persistent=False)

    def _load_from_state_dict(self, *args, **kwargs):
        super()._load_from_state_dict(*args, **kwargs)
        self._derive()

    def accumulate(self, xq: torch.Tensor) -> torch.Tensor:
        """int32 sums [B, Ho, Wo, cout] of the padded NHWC codes ``xq``."""
        if xq.is_cuda:
            _count_int8("mm")
            return int8_conv_mm(xq, self.w_mat, self.kernel, self.stride, self.weight.shape[0])
        if xq.device.type == "cpu":
            _count_int8("plain")
            return int8_conv_plain(xq, self.weight, self.stride)
        raise RuntimeError(f"no int8 conv for a tensor on {xq.device}")

    def forward(self, x: torch.Tensor, circular: bool | None = None) -> torch.Tensor:
        circular = self.circular if circular is None else circular
        xq = pad_nhwc(quantize_activation(x.permute(0, 2, 3, 1), self.inv_sx),
                      self.static_pad, circular)
        y = (self.accumulate(xq).float() * self.scale).to(x.dtype)
        if self.bias is not None:
            y = y + self.bias.to(x.dtype)
        return y.permute(0, 3, 1, 2)


_REMAT = threading.local()


def _recomputing() -> bool:
    """True inside the recompute of a ``checkpoint``ed function."""
    return getattr(_REMAT, "depth", 0) > 0


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` (its state-dict keys, running statistics in float32)
    with the JAX package's dtype rules and a recompute that leaves the
    running statistics alone."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        update = self.training and not _recomputing()
        factor = 0.0
        if update:
            self.num_batches_tracked.add_(1)
            factor = (self.momentum if self.momentum is not None
                      else 1.0 / float(self.num_batches_tracked))
        if x.dtype != torch.float32:
            return self._forward_low_precision(x, update, factor)
        mean, var = self.running_mean, self.running_var
        if self.training and not update:
            # the recompute normalises as the forward did; its fold goes to copies
            mean, var = mean.clone(), var.clone()
        return F.batch_norm(x, mean, var, _like(self.weight, x), _like(self.bias, x),
                            self.training, factor, self.eps)

    def _forward_low_precision(self, x, update: bool, factor: float) -> torch.Tensor:
        """``bn_apply`` on a bfloat16 input, with JAX's type promotions."""
        if self.training:
            xf = x.float()
            mean = xf.mean(dim=(0, 2, 3)).to(x.dtype)
            var = xf.var(dim=(0, 2, 3), unbiased=False).to(x.dtype)
            if update:
                n = x.numel() // x.shape[1]
                unbiased = var.detach() * (n / max(n - 1, 1))
                with torch.no_grad():
                    self.running_mean.copy_((1 - factor) * self.running_mean
                                            + factor * mean.detach())
                    self.running_var.copy_((1 - factor) * self.running_var + factor * unbiased)
        else:
            mean, var = self.running_mean, self.running_var
        inv = self.weight * torch.rsqrt(var + self.eps)

        def per_channel(v):
            return v.to(x.dtype).view(1, -1, 1, 1)

        return (x - per_channel(mean)) * per_channel(inv) + per_channel(self.bias)


def batch_norm(c: int) -> BatchNorm2d:
    return BatchNorm2d(c, eps=BN_EPS, momentum=BN_MOMENTUM)


def deconv2x2(cin: int, cout: int) -> ConvTranspose2d:
    """Decoder upsampling: ``ConvTranspose2d(k=2, s=2)`` (no output overlap)."""
    return ConvTranspose2d(cin, cout, 2, stride=2)


def checkpoint(fn: Callable, *args, generator: torch.Generator | None = None):
    """``fn(*args)``, its activations recomputed in the backward instead of
    kept (``torch.utils.checkpoint`` without re-entry); a plain call when
    autograd is off.

    The recompute runs with ``_recomputing()`` true, so ``BatchNorm2d``
    normalises with the same batch statistics without folding them in
    again.  ``generator``: the caller's drop-connect draws, which
    ``preserve_rng_state`` does not cover: the recompute starts from the
    state it had at the forward, and leaves it where the backward found it.
    """
    if not torch.is_grad_enabled():
        return fn(*args)
    at_forward = generator.get_state() if generator is not None else None

    @contextlib.contextmanager
    def recompute():
        now = generator.get_state() if generator is not None else None
        _REMAT.depth = getattr(_REMAT, "depth", 0) + 1
        try:
            if generator is not None:
                generator.set_state(at_forward)
            yield
        finally:
            _REMAT.depth -= 1
            if generator is not None:
                generator.set_state(now)

    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=False,
        context_fn=lambda: (contextlib.nullcontext(), recompute()))


def l2_normalize(x: torch.Tensor, dim: int, eps: float = 1e-12) -> torch.Tensor:
    """x / max(||x||, eps) along ``dim`` (``F.normalize`` semantics)."""
    return F.normalize(x, p=2.0, dim=dim, eps=eps)


def max_pool(x: torch.Tensor, window: int) -> torch.Tensor:
    """NHWC max pooling, VALID, stride = window (the GT pyramid's
    downsampling)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), window).permute(0, 2, 3, 1)


def drop_connect(x: torch.Tensor, rate: float, u: torch.Tensor) -> torch.Tensor:
    """Stochastic depth from given draws: ``x / keep * floor(keep + u)`` with
    keep = 1 - rate and ``u`` uniform in [0, 1) per sample, shape
    [B, 1, 1, 1]."""
    keep = 1.0 - rate
    return x / keep * torch.floor(keep + u)


def drop_connect_random(x: torch.Tensor, rate: float,
                        generator: torch.Generator) -> torch.Tensor:
    """``drop_connect`` with ``u`` drawn from ``generator`` (on x's device)."""
    u = torch.rand((x.shape[0], 1, 1, 1), generator=generator, device=x.device,
                   dtype=x.dtype)
    return drop_connect(x, rate, u)


@torch.no_grad()
def calibrate_batch_norm_(module: nn.Module, run: Callable[[], object]) -> nn.Module:
    """Set every BatchNorm's running statistics to the batch statistics of
    one call of ``run`` (a forward pass through ``module``), then leave the
    module in eval mode.

    For runs on random weights: with torch-default init and identity
    statistics the activations shrink about threefold per conv, so the
    backbones' outputs end many orders of magnitude below their inputs and
    the matching sees little but biases.  Calibrated statistics keep every
    layer near unit scale, as trained ones would."""
    bns = [m for m in module.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: after one batch, its statistics
    module.train()
    try:
        run()
    finally:
        for m in bns:
            m.momentum = BN_MOMENTUM
        module.eval()
    return module


@torch.no_grad()
def init_uniform_(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded torch-default init: every conv, deconv and linear weight and
    bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (``kaiming_uniform_(a=sqrt(5))``
    for the weight), BatchNorm at identity.  Modules are visited in
    registration order, so one seed gives one set of weights."""
    for m in module.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            # torch's fan_in: weight.size(1) * receptive field (for a
            # transposed conv that is cout * k * k)
            fan_in = m.weight[0].numel()
            bound = math.sqrt(1.0 / fan_in)
            m.weight.uniform_(-bound, bound, generator=generator)
            if m.bias is not None:
                m.bias.uniform_(-bound, bound, generator=generator)
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return module
