"""The decoders' 3x3 convs of a ``CVM`` forward, from the model's own
``DoubleConv`` modules on the meta device (no weights are made)."""

import torch

from ccvpe_torch.models import cvm


def decoder_conv_shapes(cfg: cvm.CVMConfig, batch: int) -> list[tuple[str, tuple[int, ...]]]:
    """The 24 convs in the order a forward runs them (the localization
    decoder, then the orientation decoder, each from the coarsest stage):
    the module name (``conv{n}{suffix}.0`` or ``.2``) and (B, H, W, Cin,
    Cout).  Stage ``conv{n}`` runs at the aerial image's size over
    2 ** (n - 1)."""
    with torch.device("meta"):
        net = cvm.CVM(cfg)
    out = []
    for name, module in net.named_modules():
        if isinstance(module, cvm.DoubleConv):
            h, w = (v >> (int(name[4]) - 1) for v in cfg.sat_hw)
            out += [(f"{name}.{i}", (batch, h, w, module[i].in_channels, module[i].out_channels))
                    for i in (0, 2)]
    return out
