"""The launch plan and layout choice of the CUDA matching kernels, on the CPU.

``ccvpe_torch.ops.matching_cuda.window_segments``, ``tile_plan`` and
``choose_layout`` are pure functions of the shape, the bins, the dtype and
the device's limits: they load no library, so these tests run without a GPU
or ``nvcc``.  The kernels themselves are checked on the card by
``tests/test_torch_kernels_cuda.py`` and ``chip_smoke.py``.
"""

import numpy as np
import pytest
import torch

from ccvpe_torch.models import cvm as TC
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC

DTYPES = [torch.float32, torch.bfloat16]
SMEM_PER_BLOCK = 227 * 1024   # an H100 block's shared memory after opt-in
# the six VIGOR scales: (side of the square map, Cs), Cg == Cs at each
VIGOR_SCALES = [(8, 1280), (16, 640), (32, 320), (64, 160), (128, 80), (256, 40)]
VIGOR_SHIFTS = [64, 32, 16, 8, 4, 2]
# Oxford's (Cs, Cg) at its six scales (centred window) and KITTI's three
# scales with Cg < Cs, (Cs, Cg, shift), 16 bins
OXFORD_SCALES = [(1280, 224), (640, 112), (320, 56), (160, 28), (80, 14), (40, 7)]
KITTI_MASKED = [(2048, 512, 128), (128, 64, 16), (128, 32, 8)]


def _itemsize(dtype):
    return torch.empty((), dtype=dtype).element_size()


@pytest.mark.parametrize("bins", [1, 4, 5, 20, 21, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_tile_shared_memory_fits_a_block(dtype, bins):
    step = MC.GRANULE // _itemsize(dtype)     # channels of one granule
    for cs in range(step, 161, step):
        plan = MC.tile_plan((8, 64, 64, cs), bins, dtype)
        assert plan is not None, cs
        assert plan.smem == MC.tile_smem_bytes(cs, bins, _itemsize(dtype), plan.rows)
        assert plan.smem <= SMEM_PER_BLOCK, (cs, plan)
        assert plan.rows in MC.TILE_ROWS and plan.stages >= 2
        resident = plan.blocks_per_sm * (plan.smem + MC.SMEM_RESERVED_PER_BLOCK)
        assert 1 <= plan.blocks_per_sm <= MC.TILE_MAX_BLOCKS_PER_SM
        assert resident <= MC.H100.smem_per_sm


@pytest.mark.parametrize("bins", [1, 5, 16, 20, 21, 32])
@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_tile_shared_memory_fits_a_block(dtype, bins):
    step = MC.GRANULE // _itemsize(dtype)
    for cs in range(step, MC.K2_TILE_MAX_CHANNELS + 1, step):
        for nseg in (1, MC.max_segments(cs, cs // 2, bins)):
            plan = MC.tile_plan((8, 64, 64, cs), bins, dtype, kernel="matching_scores", nseg=nseg)
            assert plan is not None, (cs, nseg)
            assert plan.smem == MC.tile_smem_bytes(cs, bins, _itemsize(dtype), plan.rows,
                                                   "matching_scores", nseg, plan.stages)
            assert (plan.rows // plan.rpt, plan.rpt, plan.stages) in (
                MC.K2_TILE_PLANS_NARROW + MC.K2_TILE_PLANS)
            assert plan.smem <= SMEM_PER_BLOCK and 1 <= plan.blocks_per_sm
            assert plan.blocks_per_sm * (plan.smem + MC.SMEM_RESERVED_PER_BLOCK) \
                <= MC.H100.smem_per_sm


def test_k2_tile_shared_memory_by_hand():
    # 8x256x256x40 f32, Cg 20 (the fov=180 setting), 20 bins: 64 threads of
    # two rows, one stage of 128 rows of 11 granules, W 40x20 f32, scores
    # 128x20 (+4 lead), a prefix and a suffix sum per segment (20) and row,
    # one bit per channel (a 16-byte granule), g; no smax and no 1/||X||
    nseg = len(MC.window_segments(40, 20, range(0, 40, 2)).ends)
    assert nseg == 20
    want = 128 * 11 * 16 + 40 * 20 * 4 + (128 * 20 + 4) * 4 + 2 * 20 * 128 * 4 + 16 + 40 * 4
    plan = MC.tile_plan((8, 256, 256, 40), 20, torch.float32, kernel="matching_scores",
                        nseg=nseg)
    assert (plan.rows, plan.rpt, plan.stages, plan.smem, plan.blocks_per_sm) == (
        128, 2, 1, want, 4)
    assert plan.grid == (132 * 4 // 8, 8) and plan.tiles == 512
    # with Cg == Cs one segment, whose sum needs no shared memory
    assert MC.tile_smem_bytes(40, 20, 4, 128, "matching_scores", 1, 1) == \
        want - 2 * 20 * 128 * 4 - 16
    # at 160 channels a row per thread and two stages: one 128-row block per SM
    plan = MC.tile_plan((8, 64, 64, 160), 20, torch.float32, kernel="matching_scores", nseg=20)
    assert (plan.rows, plan.rpt, plan.stages, plan.blocks_per_sm, plan.smem) == (
        128, 1, 2, 1, 2 * 128 * 41 * 16 + 160 * 20 * 4 + (128 * 20 + 4) * 4
        + 2 * 20 * 128 * 4 + 32 + 160 * 4)


@pytest.mark.parametrize("dtype", DTYPES)
def test_k2_tile_plans_at_the_vigor_scales(dtype):
    # (threads, rows per thread, stages) at the four scales K2's tile takes
    # in the fov=180 setting: two rows a thread where a row is at most 320
    # bytes, else a row a thread and two stages where they fit
    want = {torch.float32: [(128, 1, 1), (128, 1, 2), (64, 2, 1), (64, 2, 1)],
            torch.bfloat16: [(128, 1, 2), (64, 2, 1), (64, 2, 1), (64, 2, 1)]}[dtype]
    got = []
    for (s, cs), shift in zip(VIGOR_SCALES[2:], VIGOR_SHIFTS[2:]):
        ks = TM.bin_shifts(cs, cs // 2, shift, range(20), "first")
        nseg = len(MC.window_segments(cs, cs // 2, ks).ends)
        plan = MC.tile_plan((8, s, s, cs), 20, dtype, kernel="matching_scores", nseg=nseg)
        got.append((plan.rows // plan.rpt, plan.rpt, plan.stages))
        # registers (__launch_bounds__) and shared memory both allow the blocks
        assert plan.blocks_per_sm <= MC._k2_reg_blocks(*got[-1][:2])
    assert got == want


def test_tile_shared_memory_by_hand():
    # 8x256x256x40 f32, 20 bins, 128-row tiles: two stages of 128 rows of 11
    # granules, W 40x20 f32, scores 128x20 (+4 lead), smax 128 (+4), 1/norm, g
    want = 2 * 128 * 11 * 16 + 40 * 20 * 4 + (128 * 20 + 4) * 4 + (128 + 4) * 4 + 128 * 4 + 40 * 4
    plan = MC.tile_plan((8, 256, 256, 40), 20, torch.float32)
    assert (plan.rows, plan.smem, plan.blocks_per_sm) == (128, want, 3)
    assert plan.grid == (132 * 3 // 8, 8) and plan.tiles == 512


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cs", [8, 16, 40, 48, 80, 120, 160, 320])
def test_padded_row_stride_is_an_odd_number_of_granules(cs, dtype):
    granules = cs * _itemsize(dtype) // MC.GRANULE
    stride = MC.tile_stride(cs, _itemsize(dtype))
    assert stride % 2 == 1 and stride in (granules, granules + 1)
    # eight rows' granules at one column fall in the eight 16-byte bank groups
    assert len({(r * stride) % 8 for r in range(8)}) == 8


@pytest.mark.parametrize("batch", [1, 3, 8])
@pytest.mark.parametrize("hw,cs", [((41, 41), 40), ((66, 66), 80), ((5, 7), 40),
                                   ((64, 64), 160), ((256, 256), 40), ((33, 31), 8)])
def test_tiles_cover_every_row_exactly_once(hw, cs, batch):
    plan = MC.tile_plan((batch, *hw, cs), 20, torch.float32)
    n = hw[0] * hw[1]
    blocks, b = plan.grid
    assert b == batch and 1 <= blocks <= plan.tiles
    assert plan.tiles == -(-n // plan.rows)
    # every block resident at once, unless the batch alone exceeds the card
    assert blocks * b <= max(b, MC.H100.sms * plan.blocks_per_sm)
    # the kernel's walk: block x of a sample takes tiles x, x + blocks, ...;
    # tile t holds rows [t * rows, min(n, (t + 1) * rows))
    seen = np.zeros(n, dtype=int)
    for bx in range(blocks):
        for t in range(bx, plan.tiles, blocks):
            seen[t * plan.rows:min(n, (t + 1) * plan.rows)] += 1
    assert (seen == 1).all()


def test_layout_choice_at_the_vigor_scales():
    want_k1 = ["warp", "warp", "warp", "tile", "tile", "tile"]
    want_k2 = ["warp", "warp", "tile", "tile", "tile", "tile"]
    for dtype in DTYPES:
        for bins in (20, 5):
            got_k1 = [MC.choose_layout("matching_epilogue", (8, s, s, cs), cs, bins, dtype)
                      for s, cs in VIGOR_SCALES]
            got_k2 = [MC.choose_layout("matching_scores", (8, s, s, cs), cs, bins, dtype)
                      for s, cs in VIGOR_SCALES]
            assert (got_k1, got_k2) == (want_k1, want_k2), (dtype, bins)
    # the fov=180 setting halves Cg: K2's masked window takes the tile layout
    # at the fine scales and at 32x32x320 too, with the segments of its own
    # windows
    for dtype in DTYPES:
        assert [MC.choose_layout("matching_scores", (8, s, s, cs), cs // 2, 20, dtype)
                for s, cs in VIGOR_SCALES] == want_k2
        for (s, cs), shift in zip(VIGOR_SCALES, VIGOR_SHIFTS):
            ks = TM.bin_shifts(cs, cs // 2, shift, range(20), "first")
            nseg = len(MC.window_segments(cs, cs // 2, ks).ends)
            assert MC.choose_layout("matching_scores", (8, s, s, cs), cs // 2, 20, dtype,
                                    nseg=nseg) == want_k2[VIGOR_SCALES.index((s, cs))]


def _preset_calls(name, monkeypatch):
    """(kernel, x shape, Cg, bins) of every matching call of one forward of
    the preset on the CPU."""
    calls = []
    for kernel in ("matching_epilogue", "matching_scores"):
        plain = getattr(TM, kernel)

        def record(x, g, shift, offsets, window="first", kernel=kernel, plain=plain):
            calls.append((kernel, tuple(x.shape), g.shape[-1], len(tuple(offsets))))
            return plain(x, g, shift, offsets, window)
        monkeypatch.setattr(TM, kernel, record)
    cfg = TC.PRESETS[name]
    net = TC.CVM(cfg).eval()
    net.init_weights_(torch.Generator().manual_seed(0))
    with torch.no_grad():
        net(torch.zeros(1, *cfg.grd_hw, 3), torch.zeros(1, *cfg.sat_hw, 3))
    return calls


@pytest.mark.parametrize("name,batch,want", [
    ("NANO", 1, ["warp"] * 6),
    ("NANO", 8, ["warp", "warp", "warp", "warp", "tile", "tile"]),
    ("TINY", 1, ["warp"] * 6),
    ("TINY", 8, ["warp", "warp", "warp", "warp", "tile", "tile"]),
])
def test_layout_choice_at_the_small_presets(name, batch, want, monkeypatch):
    calls = _preset_calls(name, monkeypatch)
    assert len(calls) == 6
    got = [MC.choose_layout(k, (batch, *shape[1:]), cg, bins, torch.float32)
           for k, shape, cg, bins in calls]
    assert got == want, calls


@pytest.mark.parametrize("name", list(TC.PRESETS))
def test_a_preset_map_of_many_narrow_rows_always_has_a_tile(name, monkeypatch):
    # every matching scale of the preset at batch 1..128, float32 and
    # bfloat16, 1, 3, 5, 7, 19 and the preset's bins, K1 and K2, and K2 also
    # at narrower windows (Cg < Cs): the layout is warp or tile, and a map
    # with enough rows for the tile and at most K1's widest tile's channels
    # always has a tile plan, so no preset shape falls back to the warp
    # layout for want of one
    calls = _preset_calls(name, monkeypatch)
    assert len(calls) >= 6
    cfg = TC.PRESETS[name]
    for _, shape, cg0, _ in calls:
        cs = shape[-1]
        for kernel, cg in ([("matching_epilogue", cs)] if cg0 == cs else []) + [
                ("matching_scores", c) for c in sorted({cg0, cs, max(1, cs // 2),
                                                        max(1, cs // 4), 1})]:
            for bins in sorted({1, 3, 5, 7, 19, cfg.bins}):
                for dtype in DTYPES:
                    for batch in range(1, 129):
                        x = (batch, *shape[1:])
                        got = MC.choose_layout(kernel, x, cg, bins, dtype)
                        assert got in ("warp", "tile"), (kernel, x, cg, bins, dtype)
                        many = (batch * shape[1] * shape[2]
                                >= MC.TILE_MIN_ROWS_PER_SM * MC.H100.sms)
                        if many and cs <= MC.K1_TILE_MAX_CHANNELS:
                            assert got == "tile", (kernel, x, cg, bins, dtype)


@pytest.mark.parametrize("cs,dtype", [(42, torch.float32), (150, torch.float32),
                                      (36, torch.bfloat16), (100, torch.bfloat16)])
def test_no_tile_where_a_row_is_not_whole_granules(cs, dtype):
    shape = (8, 128, 128, cs)
    assert MC.tile_plan(shape, 20, dtype) is None
    assert MC.tile_plan(shape, 20, dtype, kernel="matching_scores", nseg=21) is None
    assert MC.choose_layout("matching_epilogue", shape, cs, 20, dtype) == "warp"
    assert MC.choose_layout("matching_scores", shape, cs // 2, 20, dtype) == "warp"
    for kernel in ("matching_epilogue", "matching_scores"):
        with pytest.raises(ValueError, match="tile layout"):
            MC._layout(kernel, shape, cs, 20, dtype, "tile", MC.H100)
        with pytest.raises(ValueError, match="'warp' or 'tile'"):
            MC._layout(kernel, shape, cs, 20, dtype, "row", MC.H100)


def test_tile_is_k1s_alone():
    # named when the tile layout was K1's alone; it now checks which K2
    # shapes take it: where K1 does (many rows, Cs <= 160, a row of whole
    # 16-byte granules) and up to Cs = 320; with Cg < Cs (a masked window)
    # as well
    for cs, cg in ((40, 40), (40, 20), (80, 14), (160, 28), (128, 32), (8, 4), (320, 160),
                   (320, 56), (256, 64)):
        assert MC.choose_layout("matching_scores", (8, 128, 128, cs), cg, 20,
                                torch.float32) == "tile", (cs, cg)
    assert MC.choose_layout("matching_epilogue", (8, 32, 32, 320), 320, 20,
                            torch.float32) == "warp"        # K1: wide channels
    assert MC.choose_layout("matching_scores", (8, 16, 16, 640), 320, 20,
                            torch.float32) == "warp"        # few rows, wide channels
    assert MC.choose_layout("matching_scores", (8, 64, 64, 642), 320, 20,
                            torch.float32) == "warp"        # wider than 320
    assert MC.choose_layout("matching_scores", (1, 16, 16, 40), 20, 20,
                            torch.float32) == "warp"        # few rows
    assert MC.choose_layout("matching_scores", (8, 128, 128, 42), 21, 20,
                            torch.float32) == "warp"        # 42 f32 is not whole granules
    shape = (8, 256, 256, 40)
    assert MC._layout("matching_scores", shape, 20, 20, torch.float32, "tile",
                      MC.H100, nseg=20) == "tile"
    for kernel in ("matching_scores", "matching_epilogue"):
        assert MC._layout(kernel, shape, 40, 20, torch.float32, "warp", MC.H100) == "warp"
        for layout in ("row", "split"):
            with pytest.raises(ValueError, match="'warp' or 'tile'"):
                MC._layout(kernel, shape, 40, 20, torch.float32, layout, MC.H100)


def _mask_from_segments(cs, seg):
    """The [Cs, bins] 0/1 window mask that the segment table describes."""
    starts = (0, *seg.ends[:-1])
    n = len(seg.ends)
    mask = torch.zeros(cs, len(seg.first))
    for i, (f, c) in enumerate(zip(seg.first, seg.count)):
        for j in range(c):
            s = (f + j) % n
            mask[starts[s]:seg.ends[s], i] = 1
    return mask


def _segment_cases():
    cases = []
    for (s, cs), shift in zip(VIGOR_SCALES, VIGOR_SHIFTS):
        cases.append((cs, cs // 2, shift, range(20), "first"))          # VIGOR fov=180
        cases.append((cs, cs // 2, shift, range(-2, 3), "first"))       # ori prior
        cases.append((cs, cs, shift, range(20), "first"))               # Cg == Cs
    for (cs, cg), shift in zip(OXFORD_SCALES, VIGOR_SHIFTS):
        cases.append((cs, cg, shift, range(20), "center"))
        cases.append((cs, cg, shift, range(-3, 4), "center"))
    for cs, cg, shift in KITTI_MASKED:
        cases.append((cs, cg, shift, range(16), "first"))
        cases.append((cs, cg, shift, range(-2, 3), "first"))
    # windows that wrap past Cs; offsets that are not a multiple of anything
    cases += [(100, 30, 20, range(-5, 6), "first"), (100, 70, 13, range(7), "first"),
              (48, 40, 5, range(-4, 5), "center"), (64, 1, 3, range(32), "first"),
              (64, 63, 1, range(32), "first"), (8, 4, 2, range(4), "first")]
    return cases


@pytest.mark.parametrize("cs,cg,shift,offsets,window", _segment_cases())
def test_window_segments_rebuild_the_mask(cs, cg, shift, offsets, window):
    ks = TM.bin_shifts(cs, cg, shift, offsets, window)
    seg = MC.window_segments(cs, cg, ks)
    n = len(seg.ends)
    assert 1 <= n <= MC.max_segments(cs, cg, len(ks)) <= MC.MAX_SEGMENTS
    assert list(seg.ends) == sorted(set(seg.ends)) and seg.ends[-1] == cs and seg.ends[0] > 0
    assert all(0 <= f < n and 1 <= c <= n for f, c in zip(seg.first, seg.count))
    if cg == cs:
        assert seg == MC.Segments((cs,), (0,) * len(ks), (1,) * len(ks))
    assert torch.equal(_mask_from_segments(cs, seg), TM._window_mask(cs, cg, ks, "cpu"))


def test_vigor_fov180_windows_are_ten_equal_segments():
    for (s, cs), shift in zip(VIGOR_SCALES, VIGOR_SHIFTS):
        seg = MC.window_segments(cs, cs // 2, TM.bin_shifts(cs, cs // 2, shift, range(20),
                                                               "first"))
        assert seg.ends == tuple(range(shift, cs + 1, shift))
        assert seg.first == tuple(range(20)) and seg.count == (10,) * 20


def _kernel_window_sq(x, cs, cg, ks):
    """The tile kernel's window norms, in numpy f32 and in its order: per
    segment the sum of X^2, then prefix and suffix sums within blocks, then
    per bin suffix + prefix + whole blocks."""
    seg = MC.window_segments(cs, cg, ks)
    wb = MC.window_blocks(seg)
    n, blk = len(seg.ends), wb.block
    starts = (0, *seg.ends[:-1])
    s = np.stack([(x[:, a:e] ** 2).sum(-1) for a, e in zip(starts, seg.ends)], -1)
    p, q = np.zeros_like(s), s.copy()
    for j in range(n):
        p[:, j] = s[:, j] + (p[:, j - 1] if j % blk else 0)
    for b0 in range((n - 1) // blk * blk, -1, -blk):
        for j in range(min(n, b0 + blk) - 2, b0 - 1, -1):
            q[:, j] += q[:, j + 1]
    sq = []
    for i in range(len(ks)):
        v = q[:, wb.suffix[i]].copy()
        if wb.prefix[i] >= 0:
            v += p[:, wb.prefix[i]]
        for t in range(wb.nwhole[i]):
            v += q[:, (wb.whole[i] + t) % -(-n // blk) * blk]
        sq.append(v)
    return np.stack(sq, -1)


@pytest.mark.parametrize("cs,cg,shift,offsets,window", _segment_cases())
def test_segment_sums_give_the_window_norms(cs, cg, shift, offsets, window):
    # exactly 0 for a row that is zero, and for one zero inside a window only
    rng = np.random.default_rng(cs + cg)
    ks = TM.bin_shifts(cs, cg, shift, offsets, window)
    x = rng.standard_normal((4, cs)).astype(np.float32)
    x[1] = 0
    x[2, (np.arange(cg) + ks[1 % len(ks)]) % cs] = 0
    sq = _kernel_window_sq(x, cs, cg, ks)
    want = (x.astype(np.float64) ** 2) @ TM._window_mask(cs, cg, ks, "cpu").double().numpy()
    np.testing.assert_allclose(sq, want, rtol=1e-5, atol=0)
    assert sq[1].max() == 0 and sq[2, 1 % len(ks)] == 0 and (sq[0] > 0).all()


def test_vigor_windows_take_two_sums_each():
    for (s, cs), shift in zip(VIGOR_SCALES, VIGOR_SHIFTS):
        seg = MC.window_segments(cs, cs // 2, TM.bin_shifts(cs, cs // 2, shift, range(20),
                                                               "first"))
        wb = MC.window_blocks(seg)
        assert wb.block == 10 and wb.nwhole == (0,) * 20 and wb.suffix == tuple(range(20))
        assert wb.prefix == (-1, *range(10, 19), -1, *range(0, 9))


def test_plan_follows_the_device_limits():
    # a card with fewer SMs and less shared memory: fewer blocks, smaller tiles
    small = MC.DeviceLimits(sms=16, smem_per_sm=100 * 1024)
    plan = MC.tile_plan((8, 64, 64, 160), 20, torch.float32, small)
    assert plan.rows == 32 and plan.smem <= small.smem_per_sm - MC.SMEM_RESERVED_PER_BLOCK
    assert plan.blocks_per_sm == 1 and plan.grid == (16 // 8, 8)
    assert MC.tile_plan((8, 64, 64, 160), 20, torch.float32,
                        MC.DeviceLimits(sms=16, smem_per_sm=50 * 1024)) is None
    big = MC.tile_plan((8, 64, 64, 160), 20, torch.float32)
    assert big.rows == 128 and big.grid == (132 // 8, 8)
    # K2: the next plan of its list where the first does not fit
    k2 = MC.tile_plan((8, 64, 64, 160), 20, torch.float32, small, "matching_scores", 20)
    assert (k2.rows, k2.rpt, k2.stages) == (64, 1, 1)
    assert k2.smem <= small.smem_per_sm - MC.SMEM_RESERVED_PER_BLOCK < MC.tile_smem_bytes(
        160, 20, 4, 128, "matching_scores", 20, 1)
