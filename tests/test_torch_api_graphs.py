"""``predict_batch``'s CUDA graphs (``api.GraphedForward``, ``ops.graphs``)
on the card: replays against the eager ``forward_readout`` over a pool of
distinct seeded batches (VIGOR at 360 degrees, VIGOR at 180 degrees with a
+-2-bin prior, KITTI; int8), captures of new signatures beside the old
ones, a bound on the sets a caller's many signatures keep, the
``MicroBatcher`` path, two replicas on one card, the launch
counters per call, and the replayed kernels under their spans in a profile.

Every test here needs an NVIDIA GPU and ``nvcc`` and skips without them.
This file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_api_graphs.py

The graphs run the eager forward's kernels on the same shapes, so their
answers are expected bit for bit; the bars are the pose's: the same pixel,
probability and heading within 1e-6 relative.
"""

import concurrent.futures
import copy

import numpy as np
import pytest
import torch

from ccvpe_torch import api, serve
from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.models import cvm
from ccvpe_torch.nn import layers, quant
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.ops import conv_cuda, matching_cuda

pytestmark = pytest.mark.cuda

BATCH = 4
REL = 1e-6
SETTINGS = {"vigor_360": ("VIGOR", dict()),
            "vigor_fov180_prior": ("VIGOR", dict(fov=180.0, ori_noise=36.0)),
            "kitti": ("KITTI", dict())}


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _images(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, *cfg.grd_hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (batch, *cfg.sat_hw, 3), dtype=np.uint8))


def _model(preset: str, dev) -> api.CVMModel:
    """Seeded weights with BatchNorm statistics from one seeded batch, so
    that the poses depend on the images."""
    cfg = cvm.PRESETS[preset]
    net = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(0))
    net = net.eval().to(device=dev, memory_format=torch.channels_last)
    grd, sat = (normalize_images(torch.from_numpy(x).to(dev)) for x in _images(cfg, 2, 99))
    calibrate_batch_norm_(net, lambda: net(grd, sat))
    return api.CVMModel(cfg, net, dev)


@pytest.fixture(scope="module")
def models(cuda):
    out = {}

    def get(preset):
        if preset not in out:
            out[preset] = _model(preset, cuda)
        return out[preset]
    return get


def _eager_poses(model, grd, sat, **kw):
    _, r = model.forward_readout(grd, sat, **kw)
    r = {k: v.cpu().numpy() for k, v in r.items()}
    return api._poses_from_readout(r, grd.shape[0], kw.get("return_heatmap", False))


def _close(a: float, b: float) -> bool:
    return abs(a - b) <= REL * max(abs(b), 1e-30)


def _assert_same(got, want, tag=""):
    assert [(p.row, p.col) for p in got] == [(q.row, q.col) for q in want], tag
    for p, q in zip(got, want):
        assert _close(p.probability, q.probability), (tag, p, q)
        assert _close(p.orientation_deg, q.orientation_deg), (tag, p, q)
        if q.heatmap is not None:
            assert np.abs(p.heatmap - q.heatmap).max() <= REL * np.abs(q.heatmap).max(), tag


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_replays_answer_as_the_eager_forward(models, setting):
    preset, kw = SETTINGS[setting]
    model = models(preset)
    model.graphs.clear()
    pool = [_images(model.cfg, BATCH, seed) for seed in range(4)]
    calls = pool + pool[:1]
    got = [model.predict_batch(g, s, **kw) for g, s in calls]
    assert len(model.graphs) == 1
    for i, ((g, s), poses) in enumerate(zip(calls, got)):
        _assert_same(poses, _eager_poses(model, g, s, **kw), f"{setting} call {i}")
    # stale static inputs would repeat the answer before
    for a, b in zip(got, got[1:]):
        assert [p.probability for p in a] != [p.probability for p in b]


def test_a_new_signature_captures_again_and_keeps_the_old_graphs(models):
    model = models("VIGOR")
    model.graphs.clear()
    g, s = _images(model.cfg, BATCH, 10)
    g2, s2 = _images(model.cfg, BATCH, 11)
    variants = [dict(), dict(return_heatmap=True), dict(fov=180.0)]
    for kw in variants:
        model.predict_batch(g, s, **kw)
    model.predict_batch(g[:2], s[:2])
    assert len(model.graphs) == 4
    for kw in variants:
        _assert_same(model.predict_batch(g2, s2, **kw), _eager_poses(model, g2, s2, **kw),
                     str(kw))
    _assert_same(model.predict_batch(g2[:2], s2[:2]), _eager_poses(model, g2[:2], s2[:2]),
                 "batch 2")
    assert len(model.graphs) == 4


def test_many_signatures_keep_the_graphs_and_their_memory_bounded(models):
    """A client's every ``fov`` is a signature: past ``MAX_GRAPH_SETS`` the
    least recently used set goes, and its memory pool with it."""
    model = models("VIGOR")
    model.graphs.clear()
    g, s = _images(model.cfg, 2, 80)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(), torch.cuda.memory_reserved()
    # 3 x MAX_GRAPH_SETS distinct crops, widths within 12 % of each other
    fovs = [320.0 + 40.0 * i / (3 * api.MAX_GRAPH_SETS) for i in range(3 * api.MAX_GRAPH_SETS)]
    widths = {int(model.cfg.grd_hw[1] * f / 360) for f in fovs}
    assert len(widths) == len(fovs)
    np.random.default_rng(0).shuffle(fovs)
    levels = []
    for i, fov in enumerate(fovs):
        model.predict_batch(g, s, fov=fov)
        assert len(model.graphs) == min(i + 1, api.MAX_GRAPH_SETS)
        if i + 1 in (api.MAX_GRAPH_SETS, len(fovs)):
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            levels.append((torch.cuda.memory_allocated() - base[0],
                           torch.cuda.memory_reserved() - base[1]))
    (full_alloc, full_res), (end_alloc, end_res) = levels
    # without the bound the end would hold three times the sets
    assert 0 < end_alloc <= 1.5 * full_alloc, levels
    assert end_res <= 1.5 * full_res, levels
    _assert_same(model.predict_batch(g, s, fov=fovs[-1]),
                 _eager_poses(model, g, s, fov=fovs[-1]), "kept")
    _assert_same(model.predict_batch(g, s, fov=fovs[0]),
                 _eager_poses(model, g, s, fov=fovs[0]), "dropped and captured again")
    model.graphs.clear()


def test_micro_batcher_replays(models):
    model = models("VIGOR")
    model.graphs.clear()
    batcher = serve.MicroBatcher(model, BATCH, max_wait_ms=1.0)
    try:
        pairs = [tuple(x[0] for x in _images(model.cfg, 1, 20 + i)) for i in range(3)]
        # one request a dispatch: the batch is the request repeated
        for g, s in pairs:
            got = batcher.submit(g, s, return_heatmap=False)
            want = _eager_poses(model, np.stack([g] * BATCH), np.stack([s] * BATCH))[0]
            _assert_same([got], [want], "sequential")
        assert len(model.graphs) == 1 and batcher.dispatches == 3
        # a burst from several threads: every answer the same pixel
        with concurrent.futures.ThreadPoolExecutor(6) as ex:
            burst = list(ex.map(lambda p: batcher.submit(*p, return_heatmap=False),
                                pairs * 2))
        for (g, s), got in zip(pairs * 2, burst):
            want = _eager_poses(model, np.stack([g] * BATCH), np.stack([s] * BATCH))[0]
            assert (got.row, got.col) == (want.row, want.col)
        assert len(model.graphs) == 1
    finally:
        batcher.stop()


def test_two_replicas_on_one_card_keep_their_own_graphs(models, cuda):
    one = models("VIGOR")
    two = api.CVMModel(one.cfg, one.net, cuda, mesh=[cuda, cuda])
    g, s = _images(one.cfg, BATCH, 30)
    g2, s2 = _images(one.cfg, BATCH, 31)
    two.predict_batch(g, s)
    got = two.predict_batch(g2, s2)
    assert [len(rep.graphs) for rep in two.replicas] == [1, 1]
    ga, gb = (next(iter(rep.graphs.values())) for rep in two.replicas)
    assert ga.grd.data_ptr() != gb.grd.data_ptr()
    half = BATCH // 2
    want = (_eager_poses(one, g2[:half], s2[:half])
            + _eager_poses(one, g2[half:], s2[half:]))
    _assert_same(got, want, "mesh")


def _counts():
    return conv_cuda.launch_counts(), matching_cuda.launch_counts(), layers.int8_counts()


def _per_call(model, calls, **kw):
    """The launch counters' growth over each of ``calls`` calls."""
    out = []
    for i in range(calls):
        before = _counts()
        model.predict_batch(*_images(model.cfg, BATCH, 40 + i), **kw)
        torch.cuda.synchronize()
        after = _counts()
        out.append(tuple({k: a[k] - b[k] for k in a} for a, b in zip(after, before)))
    return out


@pytest.mark.parametrize("setting", list(SETTINGS))
def test_counters_count_each_replay(models, setting):
    preset, kw = SETTINGS[setting]
    model = models(preset)
    model.graphs.clear()
    calls = _per_call(model, 4, **kw)
    # the first call runs eagerly and captures; the others replay
    assert all(c == calls[0] for c in calls), calls
    conv, matching, _ = calls[0]
    assert sum(conv.values()) == 24
    # all but the last conv of each branch (Cout 1 and 2) on the halo kernel
    assert (conv_cuda.halo_launches(conv), conv[conv_cuda.DIRECT]) == (22, 2), conv
    k1, k2 = matching["matching_epilogue"], matching["matching_scores"]
    want = {"vigor_360": (6, 0), "vigor_fov180_prior": (0, 7), "kitti": (1, 5)}[setting]
    assert (k1, k2) == want


def test_int8_model_replays(models, cuda):
    model = models("VIGOR")
    q = api.CVMModel(model.cfg, copy.deepcopy(model.net), cuda)
    q.quantize_int8()
    assert quant.quantized_fraction(q.net) > 0 and q.uses_graphs()
    pool = [_images(q.cfg, BATCH, 50 + i) for i in range(3)]
    got = [q.predict_batch(g, s) for g, s in pool]
    assert len(q.graphs) == 1
    for i, ((g, s), poses) in enumerate(zip(pool, got)):
        _assert_same(poses, _eager_poses(q, g, s), f"int8 call {i}")
    calls = _per_call(q, 2)
    assert calls[0] == calls[1] and calls[0][2]["mm"] > 0


def test_quantize_int8_drops_the_float_graphs(models, cuda):
    model = models("KITTI")
    q = api.CVMModel(model.cfg, copy.deepcopy(model.net), cuda)
    g, s = _images(q.cfg, 2, 60)
    q.predict_batch(g, s)
    assert len(q.graphs) == 1
    q.quantize_int8()
    assert not q.graphs
    q.predict_batch(g, s)
    assert len(q.graphs) == 1
    g2, s2 = _images(q.cfg, 2, 61)
    _assert_same(q.predict_batch(g2, s2), _eager_poses(q, g2, s2), "int8 after float")


def test_profiler_sees_the_replayed_kernels_under_their_spans(models):
    """Each part's kernels attach to its ``ccvpe::replay`` operator inside
    its span, as the benchmark's span readers find them; K1 runs inside
    the localization decoder's replay."""
    from torch.profiler import ProfilerActivity, profile

    model = models("VIGOR")
    g, s = _images(model.cfg, BATCH, 70)
    model.predict_batch(g, s)
    model.predict_batch(g, s)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.predict_batch(g, s)
        torch.cuda.synchronize()
    replays = [e for e in prof.events() if e.name == "ccvpe::replay"]
    assert len(replays) == 5

    def span_of(e):
        p = e.cpu_parent
        while p is not None and not p.name.startswith(("cvm.", "predict.")):
            p = p.cpu_parent
        return None if p is None else p.name

    spans = [span_of(e) for e in sorted(replays, key=lambda e: e.time_range.start)]
    assert spans == [cvm.GROUND_ENCODER, cvm.AERIAL_ENCODER, cvm.LOCALIZATION_DECODER,
                     cvm.ORIENTATION_DECODER, "predict.forward"]
    for e in replays:
        assert e.kernels, span_of(e)
    loc = next(e for e in replays if span_of(e) == cvm.LOCALIZATION_DECODER)
    names = [k.name for k in loc.kernels]
    assert any("match_" in n for n in names), names[:20]
    assert any("conv3x3" in n for n in names), names[:20]
