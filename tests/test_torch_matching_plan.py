"""The launch plan and layout choice of the CUDA matching kernels, on the CPU.

``ccvpe_torch.ops.matching_cuda.tile_plan`` and ``choose_layout`` are pure
functions of the shape, the bins, the dtype and the device's limits: they
load no library, so these tests run without a GPU or ``nvcc``.  The kernel
itself is checked on the card by ``tests/test_torch_kernels_cuda.py`` and
``chip_smoke.py``.
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
    want_k2 = ["warp", "warp", "warp", "row", "row", "row"]
    for dtype in DTYPES:
        for bins in (20, 5):
            got_k1 = [MC.choose_layout("matching_epilogue", (8, s, s, cs), cs, bins, dtype)
                      for s, cs in VIGOR_SCALES]
            got_k2 = [MC.choose_layout("matching_scores", (8, s, s, cs), cs, bins, dtype)
                      for s, cs in VIGOR_SCALES]
            assert (got_k1, got_k2) == (want_k1, want_k2), (dtype, bins)
    # the fov=180 setting halves Cg: K2's masked window, never the tile layout
    assert [MC.choose_layout("matching_scores", (8, s, s, cs), cs // 2, 20, torch.float32)
            for s, cs in VIGOR_SCALES] == want_k2


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
    ("NANO", 8, ["warp", "warp", "warp", "warp", "tile", "row"]),
    ("TINY", 1, ["warp"] * 6),
    ("TINY", 8, ["warp", "warp", "warp", "warp", "row", "row"]),
])
def test_layout_choice_at_the_small_presets(name, batch, want, monkeypatch):
    calls = _preset_calls(name, monkeypatch)
    assert len(calls) == 6
    got = [MC.choose_layout(k, (batch, *shape[1:]), cg, bins, torch.float32)
           for k, shape, cg, bins in calls]
    assert got == want, calls


@pytest.mark.parametrize("cs,dtype", [(42, torch.float32), (150, torch.float32),
                                      (36, torch.bfloat16), (100, torch.bfloat16)])
def test_no_tile_where_a_row_is_not_whole_granules(cs, dtype):
    shape = (8, 128, 128, cs)
    assert MC.tile_plan(shape, 20, dtype) is None
    assert MC.choose_layout("matching_epilogue", shape, cs, 20, dtype) == "row"
    with pytest.raises(ValueError, match="tile layout"):
        MC._layout("matching_epilogue", shape, cs, 20, dtype, "tile", MC.H100)


def test_tile_is_k1s_alone():
    shape = (8, 256, 256, 40)
    with pytest.raises(ValueError, match="'warp' or 'row'"):
        MC._layout("matching_scores", shape, 40, 20, torch.float32, "tile", MC.H100)
    assert MC._layout("matching_epilogue", shape, 40, 20, torch.float32, "row",
                      MC.H100) == "row"


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
