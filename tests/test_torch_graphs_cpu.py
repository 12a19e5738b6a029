"""What the CPU can check of ``predict_batch``'s CUDA graphs: the forward's
four-method split against the monolithic forward it replaced, the graph
signature, that the CPU path never captures, and the launch tallies that
let the kernels' counters count replays (``ops.graphs``).  The graphs
themselves run on the card: ``tests/test_torch_api_graphs.py``."""

import threading

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from ccvpe_torch import api
from ccvpe_torch.models import cvm
from ccvpe_torch.nn.layers import checkpoint, l2_normalize
from ccvpe_torch.ops import graphs, matching


def _monolithic_forward(net, grd, sat, *, loc_offsets=None, circular=None,
                        matching_impl="kernel", generator=None, remat=False):
    """``CVM.forward`` as one body, as it was before the four methods."""
    cfg = net.cfg
    remat_enc, remat_dec = cvm.remat_scopes(remat)
    if matching_impl == "kernel":
        scores_fn, epilogue_fn = matching.matching_scores, matching.matching_epilogue
    else:
        scores_fn = matching.matching_scores_plain
        epilogue_fn = matching.matching_epilogue_plain
    full_bins = tuple(range(cfg.bins))
    loc_bins = full_bins if loc_offsets is None else tuple(int(o) for o in loc_offsets)
    cl = torch.channels_last
    grd = grd.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    grd_feat, _ = net.grd_efficientnet(grd, circular, generator, remat_enc)
    descs = [net._grd_descriptor(k, grd_feat) for k in range(cvm.N_SCALES)]
    sat = sat.permute(0, 3, 1, 2).contiguous(memory_format=cl)
    sat_feat, ms = net.sat_efficientnet(sat, generator=generator, remat=remat_enc)
    skips = [ms[i] for i in cfg.skip_blocks]
    sat_desc = net._sat_descriptor_grid(sat_feat)
    stacks = []
    x = sat_desc
    for s in range(cvm.N_SCALES):
        g = descs[s]
        if g.shape[-1] == x.shape[-1]:
            stack, smax, xnorm = epilogue_fn(x, g, cfg.shifts[s], loc_bins, cfg.window)
        else:
            stack = scores_fn(x, g, cfg.shifts[s], loc_bins, cfg.window)
            smax = stack.amax(dim=-1, keepdim=True)
            xnorm = l2_normalize(x, dim=-1)
        if s == 0:
            sat_desc_norm = xnorm
            if loc_bins != full_bins:
                stack = scores_fn(x, g, cfg.shifts[s], full_bins, cfg.window)
        stacks.append(stack)
        args = (s, smax, xnorm, skips[s] if s < 5 else None, matching_impl)
        y = checkpoint(net._loc_stage, *args) if remat_dec else net._loc_stage(*args)
        x = y.permute(0, 2, 3, 1)
    logits = x.reshape(x.shape[0], -1)
    heatmap = F.softmax(logits, dim=-1).reshape(x.shape)
    y = torch.cat([stacks[0], sat_desc_norm], dim=-1).permute(0, 3, 1, 2)
    for s in range(cvm.N_SCALES):
        args = ("_ori", s, y, skips[s] if s < 5 else None, matching_impl)
        y = checkpoint(net._stage, *args) if remat_dec else net._stage(*args)
    ori = l2_normalize(y, dim=1).permute(0, 2, 3, 1)
    return cvm.CVMOutputs(logits, heatmap, ori, tuple(stacks))


def _inputs(cfg, b=2, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (torch.randn((b, *cfg.grd_hw, 3), generator=gen),
            torch.randn((b, *cfg.sat_hw, 3), generator=gen))


_NETS = {}


def _net(cfg):
    if cfg.name not in _NETS:
        _NETS[cfg.name] = cvm.CVM(cfg).init_weights_(torch.Generator().manual_seed(1)).to(
            memory_format=torch.channels_last)
    return _NETS[cfg.name]


SETTINGS = {
    "all_bins": {},
    "prior": dict(loc_offsets=range(-2, 3)),
    "fov180_plain": dict(circular=False, matching_impl="plain", half=True),
    "train_dropconnect_remat": dict(train=True, remat="all"),
}


@pytest.mark.parametrize("setting", list(SETTINGS))
@pytest.mark.parametrize("cfg", [cvm.NANO, cvm.TINY], ids=lambda c: c.name)
def test_split_forward_equals_the_monolithic_forward(cfg, setting):
    kw = dict(SETTINGS[setting])
    train, half = kw.pop("train", False), kw.pop("half", False)
    net = _net(cfg).train(train)
    grd, sat = _inputs(cfg)
    if half:
        grd = grd[:, :, : grd.shape[2] // 2]
    outs = []
    for fwd in (net.forward, lambda *a, **k: _monolithic_forward(net, *a, **k)):
        gen = torch.Generator().manual_seed(7) if train else None
        with torch.set_grad_enabled(train):
            outs.append(fwd(grd, sat, generator=gen, **kw))
    net.eval()
    got, want = outs
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)


def test_parts_chain_to_the_forward():
    net = _net(cvm.NANO).eval()
    grd, sat = _inputs(cvm.NANO, seed=3)
    with torch.no_grad():
        descs = net.ground_encoder(grd)
        skips, sat_desc = net.aerial_encoder(sat)
        loc = net.localization_decoder(descs, skips, sat_desc, range(-1, 2))
        ori = net.orientation_decoder(loc, skips)
        out = net(grd, sat, loc_offsets=range(-1, 2))
    assert len(descs) == cvm.N_SCALES and len(skips) == 5
    assert torch.equal(loc.logits, out.logits_flattened)
    assert torch.equal(ori, out.ori)
    assert all(torch.equal(a, b) for a, b in zip(loc.stacks, out.matching_scores))
    with pytest.raises(ValueError, match="matching_impl must be"):
        net.localization_decoder(descs, skips, sat_desc, matching_impl="bogus")


def _signature(**change):
    grd = np.zeros((2, 64, 128, 3), np.uint8)
    sat = np.zeros((2, 128, 128, 3), np.uint8)
    kw = dict(grd=grd, sat=sat, circular=None, offsets=None, return_heatmap=False,
              tf32=(False, False))
    kw.update(change)
    return api.graph_signature(**kw)


def test_graph_signature_separates_every_key():
    base = _signature()
    variants = {
        "batch": _signature(grd=np.zeros((3, 64, 128, 3), np.uint8),
                            sat=np.zeros((3, 128, 128, 3), np.uint8)),
        "grd_width": _signature(grd=np.zeros((2, 64, 64, 3), np.uint8)),
        "grd_dtype": _signature(grd=np.zeros((2, 64, 128, 3), np.float32)),
        "sat_shape": _signature(sat=np.zeros((2, 64, 64, 3), np.uint8)),
        "circular": _signature(circular=False),
        "offsets": _signature(offsets=range(-2, 3)),
        "other_offsets": _signature(offsets=range(-1, 2)),
        "return_heatmap": _signature(return_heatmap=True),
        "cudnn_tf32": _signature(tf32=(True, False)),
        "matmul_tf32": _signature(tf32=(False, True)),
    }
    keys = [base, *variants.values()]
    assert len(set(keys)) == len(keys)
    assert _signature(offsets=range(-2, 3)) == _signature(offsets=(-2, -1, 0, 1, 2))
    assert base == _signature()
    hash(base)


def test_signature_of_a_call_follows_fov_and_ori_noise():
    model = api.load_model(preset="NANO", seed=0, device="cpu")
    grd = np.zeros((2, *model.cfg.grd_hw, 3), np.uint8)
    cropped, circular = model._cropped(grd, 180.0)
    assert cropped.shape[2] == grd.shape[2] // 2 and circular is False
    assert model._cropped(grd, 360.0) == (grd, None)
    assert api._offsets(36.0) == range(-2, 3) and api._offsets(180.0) is None


@pytest.mark.parametrize("kw", [dict(), dict(ori_noise=36.0, fov=180.0, return_heatmap=True)])
def test_cpu_predict_batch_never_captures(kw):
    model = api.load_model(preset="NANO", seed=0, device="cpu")
    assert not model.uses_graphs()
    rng = np.random.default_rng(0)
    grd = rng.integers(0, 256, (2, *model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *model.cfg.sat_hw, 3), dtype=np.uint8)
    first = model.predict_batch(grd, sat, **kw)
    second = model.predict_batch(grd, sat, **kw)
    assert model.graphs == {}
    _, r = model.forward_readout(grd, sat, **kw)
    assert [(p.row, p.col) for p in first] == [(p.row, p.col) for p in second]
    assert [p.row for p in first] == r["row"].tolist()


class _FakeGraphed:
    """Stands in for ``api.GraphedForward`` on the CPU: what was captured,
    and a ``run`` that answers through the eager forward."""

    made: list = []

    def __init__(self, model, grd, sat, circular, offsets, return_heatmap):
        self.model, self.args = model, (circular, offsets, return_heatmap)
        self.runs = 0
        _FakeGraphed.made.append(self)

    def run(self, grd, sat):
        self.runs += 1
        circular, offsets, return_heatmap = self.args
        return self.model._eager(grd, sat, offsets, circular, return_heatmap)[1]


def test_graph_sets_are_bounded_least_recently_used_first(monkeypatch):
    """A caller's many signatures (``ori_noise``, ``return_heatmap``) keep at
    most ``MAX_GRAPH_SETS`` sets; a hit makes a set the newest, the oldest
    goes first, and a dropped signature captures again."""
    monkeypatch.setattr(api, "GraphedForward", _FakeGraphed)
    monkeypatch.setattr(api.CVMModel, "uses_graphs", lambda self: True)
    monkeypatch.setattr(_FakeGraphed, "made", [])
    model = api.load_model(preset="NANO", seed=0, device="cpu")
    rng = np.random.default_rng(1)
    grd = rng.integers(0, 256, (2, *model.cfg.grd_hw, 3), dtype=np.uint8)
    sat = rng.integers(0, 256, (2, *model.cfg.sat_hw, 3), dtype=np.uint8)
    settings = [dict(ori_noise=18.0 * n, return_heatmap=h) for h in (False, True)
                for n in range(6)]
    assert len(settings) > api.MAX_GRAPH_SETS + 2

    def call(kw):
        poses = model.predict_batch(grd, sat, **kw)
        _, r = model.forward_readout(grd, sat, **kw)
        assert [(p.row, p.col) for p in poses] == list(zip(r["row"].tolist(),
                                                           r["col"].tolist()))

    for kw in settings[:api.MAX_GRAPH_SETS]:
        call(kw)
    assert len(model.graphs) == api.MAX_GRAPH_SETS == len(_FakeGraphed.made)
    call(settings[0])                       # a hit: the first set is now the newest
    assert len(_FakeGraphed.made) == api.MAX_GRAPH_SETS
    assert _FakeGraphed.made[0].runs == 1
    for kw in settings[api.MAX_GRAPH_SETS:]:
        call(kw)
        assert len(model.graphs) == api.MAX_GRAPH_SETS
    kept = list(model.graphs.values())
    extra = len(settings) - api.MAX_GRAPH_SETS
    assert _FakeGraphed.made[0] in kept     # used again, so kept
    assert not any(g in kept for g in _FakeGraphed.made[1:1 + extra])
    assert kept[-extra:] == _FakeGraphed.made[api.MAX_GRAPH_SETS:]
    call(settings[1])                       # dropped: captures again
    assert len(_FakeGraphed.made) == len(settings) + 1
    assert list(model.graphs.values())[-1] is _FakeGraphed.made[-1]
    assert len(model.graphs) == api.MAX_GRAPH_SETS


def test_plain_model_never_captures():
    model = api.load_model(preset="NANO", seed=0, device="cpu", matching_impl="plain")
    assert not model.uses_graphs()


def test_launches_counted_while_tallying_go_to_the_tally_and_replays_add_them():
    counts, lock = {"a": 0, "b": 0}, threading.Lock()
    graphs.count(counts, lock, "a")
    tally = {}
    with graphs.tallying(tally):
        for key in ("a", "b", "b"):
            graphs.count(counts, lock, key)
    assert counts == {"a": 1, "b": 0}
    assert tally == {id(counts): (counts, lock, {"a": 1, "b": 2})}
    for _ in range(3):
        graphs.add_tally(tally)
    assert counts == {"a": 4, "b": 6}
    graphs.count(counts, lock, "a")
    assert counts["a"] == 5


def test_tallying_is_per_thread():
    counts, lock = {"k": 0}, threading.Lock()
    tally = {}
    with graphs.tallying(tally):
        t = threading.Thread(target=graphs.count, args=(counts, lock, "k"))
        t.start()
        t.join()
        graphs.count(counts, lock, "k")
    assert counts["k"] == 1 and tally[id(counts)][2] == {"k": 1}


def test_kernel_wrappers_count_through_the_tally():
    from ccvpe_torch.nn import layers
    from ccvpe_torch.ops import conv_cuda, matching_cuda

    conv_before = conv_cuda.launch_counts()["h128"]
    passes_before = conv_cuda.pass_counts()
    k1_before = matching_cuda.LAUNCH_COUNTS["matching_epilogue", "tile", "float32"]
    int8_before = layers.int8_counts()["mm"]
    tally = {}
    with graphs.tallying(tally):
        conv_cuda._count("h128")
        conv_cuda._count(None, "wgrad")
        matching_cuda._count("matching_epilogue", "tile", torch.float32)
        layers._count_int8("mm")
    assert conv_cuda.launch_counts()["h128"] == conv_before
    assert conv_cuda.pass_counts() == passes_before
    assert layers.int8_counts()["mm"] == int8_before
    graphs.add_tally(tally)
    assert conv_cuda.launch_counts()["h128"] == conv_before + 1
    passes = conv_cuda.pass_counts()
    assert {k: passes[k] - passes_before[k] for k in conv_cuda.PASSES} == {
        "forward": 1, "dgrad": 0, "wgrad": 1}
    assert matching_cuda.LAUNCH_COUNTS["matching_epilogue", "tile", "float32"] == k1_before + 1
    assert layers.int8_counts()["mm"] == int8_before + 1
