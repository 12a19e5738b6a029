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
