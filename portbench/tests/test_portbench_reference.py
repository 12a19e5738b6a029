"""The plain reference against the program at test sizes on the CPU, and
the work counts checked by hand."""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench.lib import harness, peaks, program, weights
from portbench.reference import cvm as ref
from portbench.reference import flops
from portbench.tests import portbench_cells


def _arch(preset: str) -> ref.Arch:
    from ccvpe_torch.models import cvm

    d = {k: list(v) if isinstance(v, tuple) else v
         for k, v in dataclasses.asdict(cvm.PRESETS[preset]).items()}
    return ref.arch_from({"architecture": d})


@pytest.mark.parametrize("preset", ["VIGOR", "KITTI", "TINY", "NANO"])
def test_checkpoint_layout_is_the_programs(preset):
    from ccvpe_torch.models import cvm

    with torch.device("meta"):
        want = {k: tuple(v.shape) for k, v in cvm.CVM(cvm.PRESETS[preset]).state_dict().items()}
    assert ref.param_shapes(_arch(preset)) == want


@pytest.mark.parametrize("preset,fov", [("NANO", 360.0), ("TINY", 360.0), ("NANO", 180.0)])
def test_forward_matches_the_program(preset, fov):
    """The program's plain path on the CPU against the reference, on the
    benchmark's seeded weights: logits, orientation and every matching
    volume (float32 sums in another order and layout)."""
    from ccvpe_torch.models import cvm

    arch = _arch(preset)
    sd = weights.make_state_dict(arch, 11, "cpu")
    precision = harness.precision_of(portbench_cells.nano_config())
    model = program.serving_model(cvm.PRESETS[preset], sd, torch.device("cpu"), precision, 180.0)
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 256, (2, *arch.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *arch.sat_hw, 3), dtype=np.uint8)
    out, r = model.forward_readout(grd, sat, ori_noise=180.0, fov=fov)
    if fov < 360:
        grd = grd[:, :, :int(grd.shape[2] * fov / 360)]
    with torch.no_grad():
        want = ref.forward(sd, arch, ref.normalize(torch.from_numpy(grd)),
                           ref.normalize(torch.from_numpy(sat)),
                           circular=arch.circular and fov >= 360)

    def rel(a, b):
        return float((a.float() - b).abs().max() / b.abs().max())

    assert rel(out.logits_flattened, want.logits) < 1e-4
    assert rel(out.ori, want.ori) < 1e-4
    for a, b in zip(out.matching_scores, want.scores):
        assert rel(a, b) < 1e-4
    picks = [(b, int(r["row"][b]), int(r["col"][b])) for b in range(2)]
    got = [(float(r["prob"][b]), program.heading_deg(float(r["cos"][b]), float(r["sin"][b])))
           for b in range(2)]
    prob, ori = program.pose_gaps(got, program.reference_at(want, picks))
    assert prob < 1e-4 and ori < 1e-4


def test_weights_depend_on_the_seed_alone():
    arch = _arch("NANO")
    a, b = weights.make_state_dict(arch, 5, "cpu"), weights.make_state_dict(arch, 5, "cpu")
    c = weights.make_state_dict(arch, 2**31 + 9, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    w = "grd_efficientnet._conv_stem.weight"
    assert not torch.equal(a[w], c[w])
    bound = 1 / math.sqrt(3 * 3 * 3)
    assert a[w].abs().max() <= bound and a[w].abs().max() > 0.9 * bound
    assert float(a["grd_efficientnet._fc.weight"].abs().max()) == 0.0
    # calibrated: running statistics are no longer the identity
    assert float(a["sat_efficientnet._bn0.running_var"].sub(1).abs().max()) > 1e-3


def test_conv_flops_by_hand():
    x = torch.empty((2, 3, 320, 640), device="meta")
    w = torch.empty((32, 3, 3, 3), device="meta")
    with FlopCounterMode(display=False) as c:
        y = ref._conv(x, w, stride=2, pad=ref.same_pad((224, 224), 3, 2), circular=True)
    assert tuple(y.shape) == (2, 32, 160, 320)
    assert c.get_total_flops() == 2 * (2 * 160 * 320) * 32 * (3 * 3 * 3)


@pytest.mark.parametrize("groups,transposed", [(1, False), (64, False), (1, True)])
def test_conv_backward_flops_by_hand(groups, transposed):
    x = torch.empty((2, 64, 16, 16), device="meta", requires_grad=True)
    if transposed:
        w = torch.empty((64, 32, 2, 2), device="meta", requires_grad=True)
        conv = lambda: torch.nn.functional.conv_transpose2d(x, w, stride=2)  # noqa: E731
        forward = 2 * 64 * 32 * 2 * 2 * (2 * 16 * 16)
    else:
        w = torch.empty((64, 64 // groups, 3, 3), device="meta", requires_grad=True)
        conv = lambda: torch.nn.functional.conv2d(x, w, padding=1, groups=groups)  # noqa: E731
        forward = 2 * 64 * (64 // groups) * 9 * (2 * 16 * 16)
    with flops.counter() as c:
        y = conv()
        assert c.get_total_flops() == forward
        torch.autograd.grad(y.sum(), [x, w])
    assert c.get_total_flops() == 3 * forward


def test_model_flops():
    """The forward's operations per pair, against the count over the
    program's own forward at batch 1 (56.6 GFLOP for VIGOR, 54.7 for
    KITTI); training counts forward and backward (about three forwards)."""
    vigor = flops.forward_flops(_arch("VIGOR"), 1)
    kitti = flops.forward_flops(_arch("KITTI"), 1)
    assert abs(vigor / 56.6e9 - 1) < 0.02 and abs(kitti / 54.7e9 - 1) < 0.02
    assert flops.forward_flops(_arch("VIGOR"), 4) == 4 * vigor
    train = flops.train_flops(_arch("TINY"), 2)
    fwd = flops.forward_flops(_arch("TINY"), 2)
    assert 2.5 * fwd < train < 3.5 * fwd


def test_matching_work_by_hand():
    vigor = flops.matching_launches(_arch("VIGOR"), 8)
    assert [v.kernel for v in vigor] == ["K1"] * 6
    assert [v.x for v in vigor][0] == (8, 8, 8, 1280) and vigor[-1].x == (8, 256, 256, 40)
    k1 = vigor[0]
    pixels = 8 * 8 * 8
    assert k1.bytes == 4 * (pixels * 1280 + 8 * 1280 + pixels * (1280 + 20 + 1))
    assert k1.flops == pixels * 1280 * (2 * 20 + 3)
    kitti = flops.matching_launches(_arch("KITTI"), 8)
    assert [v.kernel for v in kitti] == ["K2"] * 5 + ["K1"]
    assert kitti[-1].x == (8, 256, 256, 32)
    k2 = kitti[0]
    assert (k2.x, k2.cg, k2.bins) == ((8, 8, 8, 2048), 512, 16)
    assert k2.bytes == 4 * (pixels * 2048 + 8 * 512 + pixels * 16)
    assert k2.flops == pixels * 2048 * (2 * 16 + 2 * 16)
    # bound by bytes on an H100 SXM at 20 bins: ~4 operations a byte
    assert peaks.bound_s(k1.bytes, k1.flops, "H100 SXM") == k1.bytes / 3.35e12
    prior = flops.matching_launches(_arch("VIGOR"), 8, range(-2, 3))
    assert [v.kernel for v in prior[:2]] == ["K1", "K2"] and prior[1].bins == 20
