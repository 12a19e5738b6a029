"""CVM_VIGOR_ori_prior at a 180-degree field of view with a +-36 degree
heading prior, ``predict_batch(..., ori_noise=36.0, fov=180.0)``: the
port's forward against the benchmark's plain reference
(``portbench/reference/cvm.py``) at TINY and NANO on the CPU, on the
benchmark's seeded weights; the work counts of the cropped model
(``portbench/lib/fov.py``) by hand; and the cell ``vigor-infer-fov180-b8``
driven whole at NANO size through its driver ``infer_bottleneck``.

The port crops the panorama to its leading half and encodes it without
circular padding; the reference is handed that crop.  The localization
branch matches the prior's five offsets ``range(-2, 3)`` at every scale,
and the bottleneck recomputes all bins for the orientation decoder (the
port's ``matching_scores[0]`` is that full-bin stack, the tensor its
orientation decoder concatenates).  Each matching call of either side is
recorded: six 5-bin stacks and the full-bin one, in the same order.

On seeded weights the orientation field hardly depends on the matching
(zeroing the stacks moves it by under 1.5e-5 at NANO and 3e-7 at TINY:
the decoder's skip maps dominate it), so the full-bin stack, not the
field, is what shows the orientation decoder's input; the cell's check
``stack_rel`` reads it.
"""

from __future__ import annotations

import copy
import dataclasses
import importlib
import json

import numpy as np
import pytest
import torch

from portbench.lib import fov, harness, peaks, program, readers, trace as trace_lib, weights
from portbench.reference import cvm as ref
from portbench.reference import flops
from portbench.tests import portbench_cells as cells
from portbench.tests.test_portbench_faults import _altered_readout

ORI_NOISE, FOV = 36.0, 180.0
PRIOR = range(-2, 3)
CELL = "vigor-infer-fov180-b8"

# Float32 on both sides, sums in another order and layout (the port NHWC
# and channels_last, the reference NCHW and einsums).  Largest readings
# over seeds 11-13 and 20-27:
# * logits, max |gap| over max |reference|: 6.2e-6 (NANO), 1.6e-6 (TINY);
#   the three controls read 4.1e-2 and more.
LOGITS_TOL = 2e-5
# * the (cos, sin) field's gap times the reference field's length there
#   over its median length (the benchmark's ``ori_gap``: where the field is
#   short, rounding turns it widely; unscaled the gap reads up to 5.7e-5):
#   2.4e-6.  The controls leave the field within rounding (docstring).
ORI_TOL = 2e-5
# * each stack of cosines, max |gap| over max |reference|: 1e-5 and less,
#   but 3.9e-5-6.3e-5 at NANO's last scale, whose window holds 2 of the
#   map's 8 channels, so its norm can be small and the division amplifies
#   the rounding; the controls read 5.6e-2 and more in some stack.
STACK_TOL = 2e-4
CONTROLS = ("circular", "five_bin_orientation", "crop_from_the_end")


def _arch(preset: str) -> ref.Arch:
    from ccvpe_torch.models import cvm

    d = {k: list(v) if isinstance(v, tuple) else v
         for k, v in dataclasses.asdict(cvm.PRESETS[preset]).items()}
    return ref.arch_from({"architecture": d})


def _vigor() -> ref.Arch:
    return ref.arch_from(json.loads((harness.ROOT / "portbench/configs/vigor.json").read_text()))


def _recorded(monkeypatch, module, name: str, calls: list):
    real = getattr(module, name)

    def record(*args, **kwargs):
        out = real(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(module, name, record)
    return real


@pytest.fixture(scope="module", params=["NANO", "TINY"])
def port(request):
    """The port's eager forward at the prior and a 180-degree crop, its
    matching calls recorded: (arch, weights, images, outputs, the stacks of
    the K2 route, the count of the K1 route's calls)."""
    from ccvpe_torch.models import cvm
    from ccvpe_torch.ops import matching

    preset = request.param
    arch = _arch(preset)
    sd = weights.make_state_dict(arch, 13, "cpu")
    precision = harness.precision_of(cells.nano_config())
    model = program.serving_model(cvm.PRESETS[preset], sd, torch.device("cpu"), precision,
                                  ORI_NOISE)
    rng = np.random.default_rng(13)
    grd = rng.integers(0, 256, (2, *arch.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *arch.sat_hw, 3), dtype=np.uint8)
    scores, epilogues = [], []
    with pytest.MonkeyPatch.context() as mp:
        _recorded(mp, matching, "matching_scores", scores)
        _recorded(mp, matching, "matching_epilogue", epilogues)
        out, _ = model.forward_readout(grd, sat, ori_noise=ORI_NOISE, fov=FOV)
    return arch, sd, (grd, sat), out, scores, len(epilogues)


def _reference(arch, sd, grd, sat, monkeypatch, control=None):
    """The reference's forward at the prior on the crop (or a control) and
    its matching calls in order."""
    width = int(grd.shape[2] * FOV / 360)
    grd = grd[:, :, -width:] if control == "crop_from_the_end" else grd[:, :, :width]
    calls = []
    real = _recorded(monkeypatch, ref, "matching", calls)
    if control == "five_bin_orientation":
        # the bottleneck's full-bin recompute replaced by the 5-bin stack,
        # zero-padded or cut to the bins: the orientation decoder fed the
        # localization branch's stack
        def five(x, g, shift, offsets, window):
            out = real(x, g, shift, PRIOR, window)
            if len(tuple(offsets)) == arch.bins:
                pad = torch.zeros((*out.shape[:-1], max(arch.bins - out.shape[-1], 0)))
                out = torch.cat([out, pad], dim=-1)[..., :arch.bins]
            calls.append(out)
            return out

        monkeypatch.setattr(ref, "matching", five)
    with torch.no_grad():
        want = ref.forward(sd, arch, ref.normalize(torch.from_numpy(grd)),
                           ref.normalize(torch.from_numpy(sat)), loc_offsets=PRIOR,
                           circular=control == "circular")
    return want, calls


def _gaps(port, want, ref_stacks) -> dict[str, tuple[float, float]]:
    """Each compared number beside its tolerance."""
    _, _, _, out, stacks, _ = port

    def rel(a, b):
        return float((a.float() - b).abs().max() / b.abs().max())

    length = want.ori_norm / want.ori_norm.flatten(1).median(dim=1).values[:, None, None]
    gaps = {"logits": (rel(out.logits_flattened, want.logits), LOGITS_TOL),
            "ori": (float(((out.ori - want.ori).norm(dim=-1) * length).max()), ORI_TOL)}
    # the order of the calls: scale 0 at the prior, its full-bin recompute,
    # then scales 1-5 at the prior
    names = ["stack0", "full_bin"] + [f"stack{s}" for s in range(1, ref.N_SCALES)]
    for name, a, b in zip(names, stacks, ref_stacks, strict=True):
        gaps[name] = (rel(a, b), STACK_TOL)
    return gaps


def test_port_matches_the_reference(port, monkeypatch):
    arch, sd, (grd, sat), out, stacks, epilogues = port
    want, ref_stacks = _reference(arch, sd, grd, sat, monkeypatch)
    # K2's route at all six scales and the bottleneck, K1's never: the
    # ground descriptors are half as wide as the aerial ones
    assert epilogues == 0 and len(stacks) == 7
    assert [s.shape[-1] for s in stacks] == [5, arch.bins, 5, 5, 5, 5, 5]
    assert out.matching_scores[0] is stacks[1]
    for name, (gap, tol) in _gaps(port, want, ref_stacks).items():
        assert gap <= tol, (name, gap, tol)


@pytest.mark.parametrize("control", CONTROLS)
def test_controls_fail(port, monkeypatch, control):
    """Circular padding left on, the orientation decoder fed the 5-bin
    stack, the crop taken from the panorama's trailing half: each moves
    some compared number past its tolerance by two orders of magnitude."""
    arch, sd, (grd, sat), *_ = port
    want, ref_stacks = _reference(arch, sd, grd, sat, monkeypatch, control)
    gaps = _gaps(port, want, ref_stacks)
    assert max(gap / tol for gap, tol in gaps.values()) > 100, gaps


# ----------------------------------------------------------- the work counts

def test_cropped_arch_follows_the_backbone():
    vigor = _vigor()
    assert fov.feature_width(vigor, 640) == vigor.grd_feat_hw[1] == 20
    c = fov.cropped(vigor, FOV)
    assert (c.grd_hw, c.grd_feat_hw, c.circular) == ((320, 320), (10, 10), False)
    assert c._replace(grd_hw=vigor.grd_hw, grd_feat_hw=vigor.grd_feat_hw,
                      circular=True) == vigor
    nano = fov.cropped(_arch("NANO"), FOV)
    assert (nano.grd_hw, nano.grd_feat_hw) == ((64, 64), (2, 2))
    assert fov.cropped(vigor, 360.0) is vigor


def test_cropped_launches_by_hand():
    """At VIGOR's sizes, batch 8: seven K2 launches, no K1.  Six at the
    prior's 5 bins with the ground descriptor half the map's width, and
    the bottleneck's 20 bins at 8x8x1280; each reads g once, reads x over
    the channels its windows cover, writes its scores once, and squares x
    per bin (the masked window).  The prior's five windows, Cg wide at
    shifts of Cs/20 from -2 to 2, cover Cg + 4 Cs/20 = 0.7 Cs channels;
    the bottleneck's twenty cover all Cs."""
    launches = fov.launches(fov.cropped(_vigor(), FOV), 8, PRIOR)
    assert [v.kernel for v in launches] == ["K2"] * 7
    want = [((8, 8, 8, 1280), 640, 5), ((8, 8, 8, 1280), 640, 20),
            ((8, 16, 16, 640), 320, 5), ((8, 32, 32, 320), 160, 5),
            ((8, 64, 64, 160), 80, 5), ((8, 128, 128, 80), 40, 5),
            ((8, 256, 256, 40), 20, 5)]
    assert [(v.x, v.cg, v.bins) for v in launches] == want
    for v, whole in zip(launches, flops.matching_launches(fov.cropped(_vigor(), FOV), 8,
                                                          PRIOR)):
        b, h, w, cs = v.x
        read = cs if v.bins == 20 else v.cg + 4 * cs // 20
        assert read == (cs if v.bins == 20 else 7 * cs // 10)
        assert v.bytes == 4 * (b * h * w * read + b * v.cg + b * h * w * v.bins)
        assert v.flops == b * h * w * cs * 4 * v.bins
        assert v._replace(bytes=whole.bytes) == whole
    assert launches[0].bytes == 4 * (512 * 896 + 8 * 640 + 512 * 5) == 1865728
    assert launches[1].bytes == 4 * (512 * 1280 + 8 * 640 + 512 * 20) == 2682880
    assert launches[-1].flops == 8 * 256 * 256 * 40 * 20 == 419430400
    # every launch is bound by its bytes at the H100's rates
    assert all(v.bytes / 3.35e12 > v.flops / 67e12 for v in launches)


def test_windows_channels():
    assert fov.windows_channels(1280, 640, 64, PRIOR, "first") == 896
    assert fov.windows_channels(1280, 640, 64, range(20), "first") == 1280
    assert fov.windows_channels(40, 20, 2, PRIOR, "first") == 28
    assert fov.windows_channels(16, 4, 2, [0, 5], "first") == 8     # apart, wrapping
    assert fov.windows_channels(64, 64, 4, PRIOR, "first") == 64


def _reading(cell: str, trace=None) -> dict:
    return {"trace": trace, "readings": {"batch": 8, "pairs_per_s": 200.0},
            "cell": harness.load_cell(cell), "part": "H100 SXM"}


def _matching_trace(k1_us: float, k2_us: float, iters: int = 2) -> trace_lib.Trace:
    device = [(0, k1_us, "match_tile_kernel"), (k1_us, k1_us + k2_us,
                                                "match_scores_tile_kernel")] * iters
    return trace_lib.Trace(1.0, iters, device, [], 0, [])


@pytest.mark.parametrize("cell", ["vigor-infer-b8", "kitti-infer-b8"])
def test_full_fov_counts_are_the_uncropped_ones(cell):
    """At 360 degrees the helper hands the work counts the configuration's
    own ``Arch`` and every window of x covers all its channels: the new
    readers read what ``k1_roofline``, ``k2_roofline`` and
    ``infer.mfu_pct`` read."""
    reading = _reading(cell, _matching_trace(100.0, 150.0))
    assert fov.arch(reading) == readers.arch(reading)
    assert fov.launches(fov.arch(reading), 8, readers.loc_offsets(reading)) == \
        flops.matching_launches(readers.arch(reading), 8, readers.loc_offsets(reading))
    assert fov.roofline_pct(reading, "K1") == harness._reader("k1_roofline").read(reading)
    assert harness._reader("k2_fov_roofline").read(reading) == \
        harness._reader("k2_roofline").read(reading)
    assert harness._reader("infer.fov_mfu_pct").read(reading) == \
        harness._reader("infer.mfu_pct").read(reading)


def test_cell_readers_count_the_cropped_model():
    reading = _reading(CELL, _matching_trace(0.0, 250.0))
    least = sum(peaks.bound_s(v.bytes, v.flops, "H100 SXM")
                for v in fov.launches(fov.arch(reading), 8, PRIOR))
    # every launch is bound by its bytes: 132.3 MB at 3.35 TB/s (181.9 MB
    # with the whole of x counted for the masked launches)
    assert least == pytest.approx(132306304 / 3.35e12)
    assert harness._reader("k2_fov_roofline").read(reading) == \
        pytest.approx(100 * least / 250e-6)
    per_pair = flops.forward_flops(fov.arch(reading), 8, PRIOR) / 8
    assert per_pair < flops.forward_flops(readers.arch(reading), 8, PRIOR) / 8
    assert harness._reader("infer.fov_mfu_pct").read(reading) == \
        pytest.approx(100 * per_pair * 200.0 / 67e12)
    for metric in ("k2_fov_roofline", "infer.fov_mfu_pct"):
        assert harness._reader(metric).read({**reading, "trace": None,
                                             "readings": {"batch": 8}}) is None


def test_cell_is_in_the_manifest():
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    entry = next(w for w in manifest["workloads"] if w["name"] == CELL)
    c = harness.load_cell(CELL)
    assert (entry["config"], entry["chips"], c.workload["driver"]) == (
        "vigor-fov180-prior36", 1, "infer_bottleneck")
    assert set(c.workload["checks"]) == {"prob_rel", "ori_gap", "stack_rel"}
    params = c.workload["params"]
    assert (params["ori_noise"], params["fov"], params["batch"]) == (ORI_NOISE, FOV, 8)
    assert {m["name"] for m in c.end_to_end} == {"pairs_per_s", "setup_s"}
    per_layer = {m["name"]: m for m in c.per_layer}
    assert set(per_layer) == {"k2_fov_roofline", "infer.fov_mfu_pct", "device.idle_pct.infer"}
    assert all(m["workloads"] == [CELL] and m["moves"] == "pairs_per_s"
               for name, m in per_layer.items() if name != "device.idle_pct.infer")
    assert per_layer["device.idle_pct.infer"]["workloads"][-1] == CELL


def test_config_is_vigor_at_the_cells_view():
    """The configuration holds CVM_VIGOR's sizes and weights under the same
    keys (the preset VIGOR, nothing reduced); only its name, source and
    the variant it evaluates differ, and the cell's traffic is that
    variant's."""
    manifest = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
    c = harness.load_cell(CELL)
    vigor = json.loads((harness.ROOT / "portbench/configs/vigor.json").read_text())
    conf = next(x for x in manifest["configs"] if x["name"] == c.workload["config"])
    assert conf["source"] != next(x["source"] for x in manifest["configs"]
                                  if x["name"] == "vigor")
    assert {k: v for k, v in c.config.items() if k not in ("name", "source", "about", "variant")} \
        == {k: v for k, v in vigor.items() if k not in ("name", "source", "about")}
    assert ref.arch_from(c.config) == _vigor() and c.config["reduced"] == []
    assert (c.config["variant"]["fov"], c.config["variant"]["ori_noise"]) == (FOV, ORI_NOISE)


def test_variant_and_traffic_must_agree():
    cell = harness.load_cell(CELL)
    workload = copy.deepcopy(cell.workload)
    workload["params"]["ori_noise"] = 180.0
    ctx = harness.Context(dataclasses.replace(cell, workload=workload), 1, 1.0, False,
                          torch.device("cpu"), 0.0, harness.precision_of(cell.config))
    with pytest.raises(SystemExit, match="ori_noise"):
        importlib.import_module("portbench.drivers.infer_bottleneck").run(ctx)


def _nano_cell() -> harness.Cell:
    """The cell at NANO size with ``infer``'s small traffic
    (``portbench_cells.nano_cell`` keys its sizes by driver)."""
    cell = harness.load_cell(CELL)
    workload = copy.deepcopy(cell.workload)
    workload["params"].update(cells.SMALL["infer"])
    return dataclasses.replace(cell, config=cells.nano_config(), workload=workload)


def test_cell_sound_and_altered(monkeypatch):
    """The cell whole at NANO size on the CPU: sound, its answers equal the
    reference's; with every pose's row moved by half the map, they do not."""
    result, lines = cells.run(_nano_cell(), seed=2**31 + 11, seconds=6, trace=True)
    assert result["correct"] and result["attempted"] > 0 and len(lines) == 3, lines
    # the CPU has no device intervals, so the idle share reads nothing here
    assert set(result["metrics"]) == {"infer.fov_mfu_pct"}
    assert "breakdown" in result
    _altered_readout(monkeypatch)
    result, _ = cells.run(_nano_cell(), seconds=1)
    assert not result["correct"] and result["checks"]["prob_rel"]["value"] > 1e-2
    assert set(result["metrics"]) == {"pairs_per_s", "setup_s"}


def test_five_bin_bottleneck_fails_only_the_stack_check(monkeypatch):
    """The port's orientation decoder fed the localization branch's 5-bin
    stack (zero-padded or cut to the bins): the poses hardly move, so
    ``prob_rel`` and ``ori_gap`` pass, and ``stack_rel`` does not."""
    from ccvpe_torch.ops import matching

    real = matching.matching_scores

    def five(x, g, shift, offsets, window="first"):
        n = len(tuple(offsets))
        if tuple(offsets) == tuple(PRIOR):
            return real(x, g, shift, offsets, window)
        out = real(x, g, shift, PRIOR, window)
        return torch.cat([out, torch.zeros((*out.shape[:-1], max(n - 5, 0)))], -1)[..., :n]

    monkeypatch.setattr(matching, "matching_scores", five)
    result, _ = cells.run(_nano_cell(), seconds=1)
    checks = {k: v["value"] / v["limit"] for k, v in result["checks"].items()}
    assert not result["correct"] and checks["stack_rel"] > 100, checks
    assert checks["prob_rel"] <= 1 and checks["ori_gap"] <= 1, checks
