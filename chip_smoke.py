#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ccvpe_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line:

1. device:  the card's name and power limit (``nvidia-smi``), torch and CUDA.
2. build:   ``nvcc`` builds the matching kernels from ``ccvpe_torch/csrc``.
3. kernels: each kernel, in every layout that takes the shape (warp, row,
   tile), against its plain PyTorch version on the card, at the VIGOR shapes
   (batch 8; K2 with the fov=180 masked window), the ori-prior bottleneck,
   the Oxford and KITTI masked windows at coarse and fine scales and ragged
   maps (the tile layouts also at batch 3, 41x41 and 66x66, 5 and 21 bins),
   with a zero row and, for a masked window, a row that is zero inside one
   bin's window only, in float32 and bfloat16; then times of each layout,
   the plain version and ``torch.bmm`` (a yardstick only) beside the least
   time the card could take.
4. model:   ``ccvpe_torch.api.load_model(preset="VIGOR", seed=0)`` on the
   card; ``predict_batch`` at batch 8 with ``ori_noise`` 180 and 36 and with
   ``fov=180``, counting kernel launches by kernel and by layout (K1: tile
   at the three fine scales; K2 at fov=180: tile at four, warp at two), held
   against the same model with matching forced to the plain versions; and a
   NANO model on the card held against the same model on the CPU.
5. train:   the VIGOR train step (``ccvpe_torch.train.loop``) at batch 8 in
   float32, TF32 off, on seeded weights with calibrated BN statistics and
   GT synthesized on the card: (a) one step through K1 against the same
   step through the plain versions (loss parts, every gradient, the new BN
   statistics; 6 K1 launches, 3 tile and 3 warp); (b) 2 warm-up and 5 timed
   steps with drop-connect (finite losses, everything moved, samples/s,
   peak memory); (c) one NANO step on the card against the CPU; (d) the
   device time of one step by part (forward, matching backward, rest of
   the backward, optimizer) and by kernel (``torch.profiler``).
6. timing:  steady-state ``predict_batch`` pairs/s at batch 8 in float32,
   and the device time by kernel of three calls (``torch.profiler``).

Then the ``kernels`` summary line, the raw ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script then exits
non-zero and prints no result line.  It needs one CUDA device and ``nvcc``.

``--out DIR`` also writes the ptxas report, every number of the run and the
profiler's table and trace to ``DIR``.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import re
import signal
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ccvpe_torch import api
from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.models import cvm
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.ops import _build
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC
from ccvpe_torch.train import loop as TLOOP

DEADLINE_S = 1100   # the whole run, build included, must end well inside 1200 s
BATCH = 8

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s and float32 FLOP/s outside the tensor cores.
PEAKS = {"H100 SXM": (3.35e12, 67e12), "H100 PCIe": (2.0e12, 51e12),
         "H100 NVL": (3.9e12, 60e12)}

F32_TOL = dict(atol=1e-5, rtol=1e-5)
# bf16: the kernel accumulates the bf16 inputs in f32 exactly as the f32 plain
# version does on the same (bf16-rounded) inputs, then rounds each output once
# to bf16: relative error <= 2**-8.  rtol 2**-7 leaves a factor 2 for the
# different summation order; atol covers outputs near zero.
BF16_TOL = dict(atol=1e-5, rtol=2.0 ** -7)

# The six VIGOR scales (H*W of the square map, Cs, shift), from
# ccvpe_torch.models.cvm.VIGOR: Cg == Cs at every one.
VIGOR_SCALES = [(8, 1280, 64), (16, 640, 32), (32, 320, 16), (64, 160, 8),
                (128, 80, 4), (256, 40, 2)]
KERNEL_NAMES = {"K1": "matching_epilogue", "K2": "matching_scores"}
K1_REPLACES = "ccvpe_tpu/ops/pallas_matching.py:225"
K2_REPLACES = "ccvpe_tpu/ops/pallas_matching.py:116"
SOURCE = "ccvpe_torch/csrc/matching.cu"


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def peaks_for(name: str) -> tuple[str, float, float]:
    part = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name else "H100 SXM"
    return (part, *PEAKS[part])


def time_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` after ``warmup`` calls
    (host time to issue the call included)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, reps: int = 20) -> float:
    """Device time of one call of ``fn``: ``reps`` calls captured in a CUDA
    graph, the graph replayed between two CUDA events, divided by ``reps``;
    the median of five replays.  Unlike ``time_ms`` it leaves out the host's
    time to issue each call."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(5):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / reps)
    del graph
    return statistics.median(times)


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    part, bw, f32 = peaks_for(name)
    info = {"phase": "device", "nvidia_smi": smi, "name": name,
            "power_limit": smi.split(",")[-1].strip(), "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "peaks_of": part, "peak_bytes_per_s": bw, "peak_f32_flops": f32}
    emit(info)
    return info


def phase_build(out: Path | None) -> dict:
    built = _build.build("matching", force=True)
    regs = [int(m) for m in re.findall(r"Used (\d+) registers", built.log)]
    spill = [int(a) + int(b) for a, b in
             re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", built.log)]
    info = {"phase": "build", "nvcc_seconds": built.seconds, "library": str(built.path),
            "kernels_compiled": len(regs), "max_registers": max(regs, default=None),
            "kernels_spilling": sum(1 for n in spill if n)}
    if out is not None:
        (out / "ptxas.log").write_text(built.log)
    emit(info)
    return info


def _inputs(b, hw, cs, cg, seed, dtype):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, *hw, cs), generator=gen, device="cuda").to(dtype)
    g = torch.randn((b, cg), generator=gen, device="cuda").to(dtype)
    x[0, 0, 0] = 0   # one zero row: the 1e-12 clamps
    return x, g


def _check(name, got, want, dtype) -> float:
    tol = F32_TOL if dtype == torch.float32 else BF16_TOL
    errs = []
    for a, b in zip(got, want):
        if a.dtype != dtype or a.shape != b.shape:
            raise AssertionError(f"{name}: got {a.dtype} {tuple(a.shape)}, "
                                 f"want {dtype} {tuple(b.shape)}")
        torch.testing.assert_close(a.float(), b, **tol, msg=lambda m: f"{name}: {m}")
        errs.append((a.float() - b).abs().max().item())
    return max(errs)


def _layouts(kernel, shape, cg, bins, dtype) -> list[str]:
    """Every layout of ``kernel`` ('K1' or 'K2') that takes the shape."""
    cs = shape[-1]
    tile = MC.tile_plan(shape, bins, dtype, kernel=KERNEL_NAMES[kernel],
                        nseg=MC.max_segments(cs, cg, bins))
    return (["warp"] + (["row"] if MC.row_layout_fits(cs, cg, bins) else [])
            + (["tile"] if tile else []))


def _tile_plan_times(x, g, shift) -> dict:
    """Device ms of K2's tile layout at each plan it can take (threads, rows
    per thread, stages), each forced in turn; the plan the wrapper takes by
    itself is the first of its lists that fits."""
    lists = MC.K2_TILE_PLANS_NARROW, MC.K2_TILE_PLANS
    times = {}
    try:
        for threads, rpt, stages in lists[0] + lists[1]:
            MC.K2_TILE_PLANS_NARROW, MC.K2_TILE_PLANS = (), ((threads, rpt, stages),)
            MC._plan.cache_clear()
            try:
                plan = MC._plan("matching_scores", tuple(x.shape), x.dtype, g.shape[1], shift,
                                tuple(range(20)), "first", "tile", x.device.index or 0).tile
            except ValueError:   # does not fit one block's shared memory
                continue
            times[f"t{threads} r{rpt} s{stages} b{plan.blocks_per_sm}"] = device_ms(
                lambda: MC.launch_matching_scores(x, g, shift, tuple(range(20)), "first", "tile"))
    finally:
        MC.K2_TILE_PLANS_NARROW, MC.K2_TILE_PLANS = lists
        MC._plan.cache_clear()
    return times


def _bound(nbytes: float, flops: float, dev: dict) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / dev["peak_bytes_per_s"], flops / dev["peak_f32_flops"]
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def phase_kernels(dev: dict) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    checks = []
    max_err = {(k, d): 0.0 for k in ("K1", "K2") for d in (torch.float32, torch.bfloat16)}

    def run(kernel, b, hw, cs, cg, shift, offsets, window, dtype, seed):
        x, g = _inputs(b, hw, cs, cg, seed, dtype)
        offsets = tuple(offsets)
        masked = cg < cs
        if masked:
            # the last row is zero inside bin 1's window only: its score is
            # exactly 0 there (a difference of prefix sums could give NaN)
            k1 = TM.bin_shifts(cs, cg, shift, offsets, window)[1]
            x[-1, -1, -1, (torch.arange(cg, device=x.device) + k1) % cs] = 0
        xf, gf = x.float(), g.float()
        if kernel == "K1":
            want = TM.matching_epilogue_plain(xf, gf, shift, offsets, window)
        else:
            want = (TM.matching_scores_plain(xf, gf, shift, offsets, window),)
        for layout in _layouts(kernel, (b, *hw, cs), cg, len(offsets), dtype):
            if kernel == "K1":
                got = MC.launch_matching_epilogue(x, g, shift, offsets, window, layout)
            else:
                got = (MC.launch_matching_scores(x, g, shift, offsets, window, layout),)
            torch.cuda.synchronize()
            name = (f"{kernel} {layout} x{[b, *hw, cs]} g{[b, cg]} shift {shift} offsets "
                    f"{offsets[0]}..{offsets[-1]} {window} {str(dtype)[6:]}")
            err = _check(name, got, want, dtype)
            if masked and got[0][-1, -1, -1, 1].item() != 0:
                raise AssertionError(f"{name}: a window of zeros scores "
                                     f"{got[0][-1, -1, -1, 1].item()}, not 0")
            max_err[kernel, dtype] = max(max_err[kernel, dtype], err)
            checks.append({"check": name, "max_abs_err": err})

    for dtype in (torch.float32, torch.bfloat16):
        for i, (side, cs, shift) in enumerate(VIGOR_SCALES):
            for offsets in (range(20), range(-2, 3)):
                run("K1", BATCH, (side, side), cs, cs, shift, offsets, "first", dtype, i)
            # the limited-fov path: half the panorama halves Cg (K2, masked)
            run("K2", BATCH, (side, side), cs, cs // 2, shift, range(20), "first", dtype, i)
        run("K2", BATCH, (8, 8), 1280, 1280, 64, range(20), "first", dtype, 10)
        run("K2", BATCH, (8, 8), 1280, 224, 64, range(20), "center", dtype, 11)    # Oxford
        run("K2", BATCH, (8, 8), 2048, 512, 128, range(16), "first", dtype, 12)    # KITTI
        # the fine Oxford (centred window) and KITTI (16 bins) scales
        for side, cs, cg, shift in ((64, 160, 28, 8), (128, 80, 14, 4), (256, 40, 7, 2)):
            run("K2", 2, (side, side), cs, cg, shift, range(20), "center", dtype, 17)
        for cg, shift in ((64, 16), (32, 8)):
            run("K2", 2, (64, 64), 128, cg, shift, range(16), "first", dtype, 18)
        run("K2", 2, (128, 128), 80, 40, 4, range(-2, 3), "first", dtype, 19)
        for kernel in ("K1", "K2"):
            run(kernel, 2, (41, 41), 1280, 1280, 64, range(20), "first", dtype, 13)
            run(kernel, 2, (66, 66), 320, 320, 16, range(20), "first", dtype, 14)
        # ragged maps whose score spans start off a 16-byte granule (5 and 21
        # bins), at the tile layout's widths
        for offsets in (range(-2, 3), range(21)):
            run("K1", 3, (41, 41), 40, 40, 2, offsets, "first", dtype, 15)
            run("K1", 3, (66, 66), 80, 80, 4, offsets, "first", dtype, 16)
            run("K2", 3, (41, 41), 40, 20, 2, offsets, "first", dtype, 15)
            run("K2", 3, (66, 66), 80, 40, 4, offsets, "first", dtype, 16)
    emit({"phase": "kernel_checks", "n": len(checks),
          "tolerance": {"float32": F32_TOL, "bfloat16": BF16_TOL},
          "max_abs_err": {f"{k} {str(d)[6:]}": v for (k, d), v in max_err.items()}})

    # times at the main path's shapes: float32, batch 8, 20 bins
    shapes = []

    def timed(kernel, hw, cs, cg, shift, seed):
        x, g = _inputs(BATCH, hw, cs, cg, seed, torch.float32)
        offsets = tuple(range(20))
        pixels = BATCH * hw[0] * hw[1]
        ks = TM.bin_shifts(cs, cg, shift, offsets, "first")
        banded = TM._banded(g, cs, ks)                      # [B, Cs, bins]
        x3 = x.view(BATCH, -1, cs)
        if kernel == "K1":
            def k_fn(layout=None):
                return MC.launch_matching_epilogue(x, g, shift, offsets, "first", layout)
            p_fn = lambda: TM.matching_epilogue_plain(x, g, shift, offsets, "first")
            out_elems = pixels * (cs + len(offsets) + 1)      # xnorm, scores, smax
            flops = pixels * cs * (2 * len(offsets) + 3)      # products, squares, divide
        else:
            def k_fn(layout=None):
                return MC.launch_matching_scores(x, g, shift, offsets, "first", layout)
            p_fn = lambda: TM.matching_scores_plain(x, g, shift, offsets, "first")
            out_elems = pixels * len(offsets)
            # products; squares; masked: a window product per bin
            flops = pixels * cs * (2 * len(offsets) + (2 * len(offsets) if cg < cs else 2))
        nbytes = 4 * (x.numel() + g.numel() + out_elems)
        bound, by = _bound(nbytes, flops, dev)
        layout = MC.pick_layout(KERNEL_NAMES[kernel], x, cg, len(offsets))
        by_layout = {lay: device_ms(lambda lay=lay: k_fn(lay))
                     for lay in _layouts(kernel, x.shape, cg, len(offsets), x.dtype)}
        row = {"kernel": kernel, "x": [BATCH, *hw, cs], "g": [BATCH, cg], "bins": 20,
               "layout": layout, "ms": by_layout[layout], "ms_by_layout": by_layout,
               "eager_ms": time_ms(k_fn), "plain_ms": device_ms(p_fn),
               "library_ms": device_ms(lambda: torch.bmm(x3, banded)),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops}
        row["achieved_bytes_per_s"] = nbytes / (row["ms"] * 1e-3)
        if kernel == "K2" and "tile" in by_layout:
            row["ms_by_tile_plan"] = _tile_plan_times(x, g, shift)
        shapes.append(row)
        return row

    k1 = [timed("K1", (s, s), cs, cs, shift, 20 + i)
          for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    k2 = [timed("K2", (8, 8), 1280, 1280, 64, 30)]
    # the limited-fov setting: K2 with the masked window at every scale
    k2_fov = [timed("K2", (s, s), cs, cs // 2, shift, 40 + i)
              for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    emit({"phase": "kernel_times", "card": dev["nvidia_smi"], "shapes": shapes})

    def summary(name, rows, kernel, replaces):
        total = {k: sum(r[k] for r in rows) for k in
                 ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")}
        return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
                "max_abs_err": max_err[kernel, torch.float32],
                "max_abs_err_bf16": max_err[kernel, torch.bfloat16],
                "ms": total["ms"], "kernel_ms": total["ms"], "eager_ms": total["eager_ms"],
                "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
                "bound_by": _bound(total["bytes"], total["flops"], dev)[1],
                "library_ms": total["library_ms"],
                "timed_at": "sum over x " + ", ".join(str(r["x"]) for r in rows),
                "layouts": [r["layout"] for r in rows]}

    # K2 in two rows: its one launch per ori-prior forward (the full-bin
    # bottleneck stack) and its six per fov=180 forward (masked windows), so
    # that each row's ms and launches describe the same work
    return {"checks": checks, "shapes": shapes,
            "summary": [summary("matching_epilogue (K1)", k1, "K1", K1_REPLACES),
                        summary("matching_scores (K2), ori-prior bottleneck", k2, "K2",
                                K2_REPLACES),
                        summary("matching_scores (K2), fov=180 masked window", k2_fov, "K2",
                                K2_REPLACES)]}


def _images(cfg, batch, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, (batch, *cfg.grd_hw, 3), dtype=np.uint8),
            rng.integers(0, 256, (batch, *cfg.sat_hw, 3), dtype=np.uint8))


def _calibrate(model: api.CVMModel, seed: int) -> None:
    """BatchNorm statistics from one seeded batch, so that the random
    backbones keep their activations near unit scale and the outputs depend
    on the images (with identity statistics they shrink to the biases)."""
    grd, sat = _images(model.cfg, 2, seed)
    dev = model.device
    g = normalize_images(torch.from_numpy(grd).to(dev))
    s = normalize_images(torch.from_numpy(sat).to(dev))
    calibrate_batch_norm_(model.net, lambda: model.net(g, s))


def _max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float().cpu() - b.float().cpu()).abs().max().item()


# forward outputs of the kernel path against the plain path on the card:
# float32 sums in another order, carried through the decoder's convolutions
MODEL_TOL = {"logits": 1e-3, "heatmap": 1e-7, "ori": 1e-3, "stacks": 1e-4}
HEADING_TOL_DEG = 0.1


def _compare(tag, out, ref, r, rr, tol) -> dict:
    errs = {"logits": _max_err(out.logits_flattened, ref.logits_flattened),
            "heatmap": _max_err(out.heatmap, ref.heatmap),
            "ori": _max_err(out.ori, ref.ori),
            "stacks": max(_max_err(a, b) for a, b in zip(out.matching_scores,
                                                         ref.matching_scores))}
    for k, v in errs.items():
        if not v <= tol[k]:
            raise AssertionError(f"{tag}: {k} max abs err {v} > {tol[k]}")
    for t in (out.logits_flattened, out.heatmap, out.ori, *out.matching_scores):
        if not torch.isfinite(t).all():
            raise AssertionError(f"{tag}: non-finite output")
    if not (torch.equal(r["row"].cpu(), rr["row"].cpu())
            and torch.equal(r["col"].cpu(), rr["col"].cpu())):
        raise AssertionError(f"{tag}: argmax differs: {r['row'].tolist()} {r['col'].tolist()}"
                             f" vs {rr['row'].tolist()} {rr['col'].tolist()}")
    return errs


def phase_model(dev: dict) -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t0 = time.perf_counter()
    model = api.load_model(preset="VIGOR", seed=0)
    if model.device.type != "cuda":
        raise AssertionError(f"load_model chose {model.device}, not cuda")
    _calibrate(model, seed=1)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    plain = api.CVMModel(model.cfg, model.net, model.device, matching_impl="plain")
    grd, sat = _images(model.cfg, BATCH, seed=2)
    # (setting, launches of K1 and K2 it must make): Cg == Cs at all six
    # scales of the full panorama; the prior adds the full-bin bottleneck
    # stack (K2); half the panorama halves Cg, so every scale takes K2's
    # masked window
    settings = [(dict(ori_noise=180.0), (6, 0)), (dict(ori_noise=36.0), (6, 1)),
                (dict(fov=180.0), (0, 6))]

    # K1's layouts in each full-panorama setting: tile at the three fine
    # scales, warp at the three coarse ones; K2's in the fov=180 one: tile
    # from 32x32x320 down, warp at 8x8 and 16x16
    k1_layouts = {("matching_epilogue", "tile"): 3, ("matching_epilogue", "warp"): 3}
    k2_fov_layouts = {("matching_scores", "tile"): 4, ("matching_scores", "warp"): 2}

    # the main path, one setting at a time, with every launch counter at 0
    # just before it and read just after
    poses, steps, layout_steps = [], [], []
    launches = dict.fromkeys(MC.LAUNCHES, 0)
    for kw, _ in settings:
        MC.reset_launch_counts()
        poses.append(model.predict_batch(grd, sat, return_heatmap=True, **kw))
        steps.append((MC.LAUNCHES["matching_epilogue"], MC.LAUNCHES["matching_scores"]))
        layout_steps.append({k: n for k, n in MC.LAUNCHES_BY_LAYOUT.items() if n})
        for k in launches:
            launches[k] += MC.LAUNCHES[k]
    if steps != [w for _, w in settings]:
        raise AssertionError(f"kernel launches (K1, K2) per setting {steps}, "
                             f"want {[w for _, w in settings]}")
    for (kw, _), got in zip(settings, layout_steps):
        k1 = {k: n for k, n in got.items() if k[0] == "matching_epilogue"}
        if "fov" not in kw and k1 != k1_layouts:
            raise AssertionError(f"VIGOR {kw}: K1 launches by layout {k1}, want {k1_layouts}")
        k2 = {k: n for k, n in got.items() if k[0] == "matching_scores"}
        if "fov" in kw and k2 != k2_fov_layouts:
            raise AssertionError(f"VIGOR {kw}: K2 launches by layout {k2}, want {k2_fov_layouts}")

    results = []
    for (kw, _), ps in zip(settings, poses):
        out, r = model.forward_readout(grd, sat, return_heatmap=True, **kw)
        ref, rr = plain.forward_readout(grd, sat, return_heatmap=True, **kw)
        errs = _compare(f"VIGOR {kw}", out, ref, r, rr, MODEL_TOL)
        ref_poses = plain.predict_batch(grd, sat, return_heatmap=True, **kw)
        heading = 0.0
        for p, q in zip(ps, ref_poses):
            if (p.row, p.col) != (q.row, q.col):
                raise AssertionError(f"VIGOR {kw}: pose differs: {p} vs {q}")
            if not (0 <= p.probability <= 1 and np.isfinite(p.orientation_deg)):
                raise AssertionError(f"VIGOR {kw}: bad pose {p}")
            heading = max(heading, abs((p.orientation_deg - q.orientation_deg + 180) % 360 - 180))
            hm_err = float(np.abs(p.heatmap - q.heatmap).max())
            if hm_err > MODEL_TOL["heatmap"]:
                raise AssertionError(f"VIGOR {kw}: heatmap err {hm_err}")
        if heading > HEADING_TOL_DEG:
            raise AssertionError(f"VIGOR {kw}: heading differs by {heading} deg")
        spread = out.logits_flattened.std(dim=1).min().item()
        results.append({"setting": kw, "rows": [p.row for p in ps], "cols": [p.col for p in ps],
                        "max_abs_err": errs, "heading_err_deg": heading,
                        "logit_spread_min": spread})
    info = {"phase": "model", "preset": "VIGOR", "batch": BATCH, "dtype": "float32",
            "setup_seconds": setup_s, "launches": launches,
            "launches_per_setting": dict(zip(map(json.dumps, (kw for kw, _ in settings)), steps)),
            "launches_by_layout_per_setting": {
                json.dumps(kw): {f"{k} {lay}": n for (k, lay), n in got.items()}
                for (kw, _), got in zip(settings, layout_steps)},
            "tolerance": MODEL_TOL, "heading_tolerance_deg": HEADING_TOL_DEG,
            "results": results}
    emit(info)
    info["nano"] = phase_nano_reference()
    return info, model


def phase_nano_reference() -> dict:
    """The NANO model (Cg < Cs at every scale: kernel K2's masked window) on
    the card against the same weights on the CPU (plain versions)."""
    cpu = api.load_model(preset="NANO", seed=3, device="cpu")
    _calibrate(cpu, seed=4)
    gpu = api.load_model(preset="NANO", seed=3)
    gpu.net.load_state_dict(cpu.net.state_dict(), strict=True)
    grd, sat = _images(cpu.cfg, 4, seed=5)
    # cuDNN's and the CPU's convolutions sum in other orders
    tol = {"logits": 1e-4, "heatmap": 1e-7, "ori": 1e-4, "stacks": 1e-4}
    before = sum(MC.LAUNCHES.values())
    errs = {}
    for kw in (dict(ori_noise=180.0), dict(ori_noise=36.0, fov=180.0)):
        out, r = gpu.forward_readout(grd, sat, **kw)
        ref, rr = cpu.forward_readout(grd, sat, **kw)
        errs[json.dumps(kw)] = _compare(f"NANO {kw}", out, ref, r, rr, tol)
    n = sum(MC.LAUNCHES.values()) - before
    if n != 13:    # 6 + (6 + the full-bin bottleneck stack)
        raise AssertionError(f"NANO launched the kernels {n} times, want 13")
    info = {"phase": "nano_reference", "tolerance": tol, "max_abs_err": errs}
    emit(info)
    return info


# the train step, kernel path against plain path on the card (float32, TF32
# off): loss parts rtol; each gradient tensor ||d|| <= rel * ||g_plain|| +
# abs * grad_norm; the new BN running statistics atol = rtol
TRAIN_TOL = {"loss_rtol": 1e-5, "grad_rel": 1e-3, "grad_abs": 1e-6, "bn": 1e-5}
# NANO's train step on the card against the CPU (cuDNN's and the CPU's
# convolutions and their gradients sum in other orders)
NANO_TRAIN_TOL = {"loss_rtol": 1e-4, "grad_rel": 1e-4, "grad_abs": 1e-6, "bn": 1e-4}
TRAIN_WARMUP, TRAIN_TIMED = 2, 5


def _train_batch(cfg, batch: int, seed: int, device, span: float = 200.0) -> dict:
    """Seeded uint8 images on ``device`` and their factored GT synthesized
    there: row and col offsets within +-``span`` px, angles in [0, 360)."""
    grd, sat = _images(cfg, batch, seed)
    gen = torch.Generator(device=device).manual_seed(seed)
    off = (torch.rand((2, batch), generator=gen, device=device) * 2 - 1) * span
    angle = torch.rand((batch,), generator=gen, device=device) * 360
    gt, weights, omap = GT.synthesize_batch_factored(
        off[0], off[1], angle, height=cfg.sat_hw[0], width=cfg.sat_hw[1], bins=cfg.bins)
    return {"grd": torch.from_numpy(grd).to(device), "sat": torch.from_numpy(sat).to(device),
            "gt": gt, "bin_weights": weights, "orientation": omap}


def _normalized(batch: dict) -> dict:
    """The step's input: the uint8 images ImageNet-normalised on their device."""
    return {**batch, "grd": normalize_images(batch["grd"]),
            "sat": normalize_images(batch["sat"])}


def _calibrated_state(cfg, seed: int, device=None) -> TLOOP.TrainState:
    """A seeded train state whose BN statistics come from one seeded batch."""
    state = TLOOP.create_train_state(cfg, seed=seed, device=device)
    dev = next(state.model.parameters()).device
    grd, sat = _images(cfg, 2, seed + 1)
    g = normalize_images(torch.from_numpy(grd).to(dev))
    s = normalize_images(torch.from_numpy(sat).to(dev))
    calibrate_batch_norm_(state.model, lambda: state.model(g, s))
    state.model.train()
    return state


def _compare_steps(tag, got, want, got_parts, want_parts, tol) -> dict:
    """One step of two states from the same start: loss parts, every
    gradient and the new BN running statistics."""
    errs = {}
    for k, v in want_parts.items():
        a, b = got_parts[k].item(), v.item()
        if not (math.isfinite(a) and abs(a - b) <= tol["loss_rtol"] * abs(b)):
            raise AssertionError(f"{tag}: {k} {a} vs {b}")
        errs[k] = abs(a - b) / abs(b)
    grad_norm = want_parts["grad_norm"].item()
    theirs = dict(want.model.named_parameters())
    worst, n = 0.0, 0
    for k, p in got.model.named_parameters():
        q = theirs[k]
        if (p.grad is None) != (q.grad is None):
            raise AssertionError(f"{tag}: {k} has a gradient on one side only")
        if q.grad is None:
            continue
        d = (p.grad.float().cpu() - q.grad.float().cpu()).norm().item()
        lim = tol["grad_rel"] * q.grad.float().norm().item() + tol["grad_abs"] * grad_norm
        if not d <= lim:
            raise AssertionError(f"{tag}: gradient of {k} differs by {d} > {lim}")
        worst, n = max(worst, d / lim), n + 1
    theirs = dict(want.model.named_buffers())
    bn_err = 0.0
    for k, v in got.model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v.cpu(), theirs[k].cpu(), atol=tol["bn"], rtol=tol["bn"],
                                       msg=lambda m, k=k: f"{tag}: {k}: {m}")
            bn_err = max(bn_err, (v.cpu() - theirs[k].cpu()).abs().max().item())
    return {"loss_parts_rel_err": errs, "gradient_tensors": n,
            "worst_gradient_err_over_limit": worst, "bn_max_abs_err": bn_err}


def phase_train(dev: dict, out: Path | None) -> dict:
    """The VIGOR train step at full width, batch 8, float32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cvm.VIGOR
    t0 = time.perf_counter()
    state = _calibrated_state(cfg, seed=0)
    if next(state.model.parameters()).device.type != "cuda":
        raise AssertionError("create_train_state did not place the model on cuda")
    plain = TLOOP.create_train_state(cfg, seed=0)
    plain.model.load_state_dict(state.model.state_dict())
    data = _train_batch(cfg, BATCH, seed=2, device="cuda")
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0

    # (a) kernel against plain, one step from identical weights, no drop-connect
    k_step = TLOOP.make_train_step(cfg)
    MC.reset_launch_counts()
    k_parts = k_step(state, _normalized(data))
    torch.cuda.synchronize()
    k_layouts = {k: n for k, n in MC.LAUNCHES_BY_LAYOUT.items() if n}
    p_parts = TLOOP.make_train_step(cfg, matching_impl="plain")(plain, _normalized(data))
    torch.cuda.synchronize()
    want_layouts = {("matching_epilogue", "tile"): 3, ("matching_epilogue", "warp"): 3}
    if k_layouts != want_layouts:
        raise AssertionError(f"VIGOR train step: launches by layout {k_layouts}, "
                             f"want {want_layouts}")
    if sum(MC.LAUNCHES.values()) != 6:
        raise AssertionError(f"the plain step launched a kernel: {MC.LAUNCHES}")
    check = _compare_steps("VIGOR train step kernel vs plain", state, plain, k_parts, p_parts,
                           TRAIN_TOL)
    del plain, p_parts
    torch.cuda.empty_cache()

    # (b) steps with drop-connect drawn on the card: the main path's run
    gen = torch.Generator(device="cuda").manual_seed(7)
    before = {k: v.clone() for k, v in state.model.state_dict().items()}
    for _ in range(TRAIN_WARMUP):
        k_step(state, _normalized(data), gen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    MC.reset_launch_counts()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    a.record()
    step_parts = [k_step(state, _normalized(data), gen) for _ in range(TRAIN_TIMED)]
    b.record()
    b.synchronize()
    wall_s = time.perf_counter() - w0
    launches = dict(MC.LAUNCHES)
    if launches != {"matching_epilogue": 6 * TRAIN_TIMED, "matching_scores": 0}:
        raise AssertionError(f"{TRAIN_TIMED} train steps launched {launches}")
    step_ms = a.elapsed_time(b) / TRAIN_TIMED
    loss_values = [p["loss"].item() for p in step_parts]
    if not all(math.isfinite(v.item()) for p in step_parts for v in p.values()):
        raise AssertionError(f"non-finite loss parts: {step_parts}")
    # every parameter and BN statistic moved, except the _fc heads (no gradient)
    after = state.model.state_dict()
    stay = {k for k in before if not k.endswith("num_batches_tracked")
            and torch.equal(before[k], after[k])}
    want_stay = {k for k in before if "._fc." in k}
    if stay != want_stay:
        raise AssertionError(f"these stayed through {TRAIN_WARMUP + TRAIN_TIMED} steps: "
                             f"{sorted(stay ^ want_stay)[:8]}")
    del before, after
    info = {"phase": "train", "card": dev["nvidia_smi"], "preset": "VIGOR", "batch": BATCH,
            "dtype": "float32", "setup_seconds": setup_s, "tolerance": TRAIN_TOL,
            "kernel_vs_plain": {**check, "launches_by_layout": {
                f"{k} {lay}": n for (k, lay), n in k_layouts.items()}},
            "steps": TRAIN_WARMUP + TRAIN_TIMED, "timed_steps": TRAIN_TIMED,
            "launches": launches, "losses": loss_values, "step_ms": step_ms,
            "samples_per_s": BATCH / (step_ms * 1e-3),
            "wall_samples_per_s": BATCH * TRAIN_TIMED / wall_s,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit({k: v for k, v in info.items() if k != "losses"})
    info["nano"] = phase_train_nano()
    info["profile"] = _train_profile(state, _normalized(data), gen, dev, out)
    # give the trainer's memory back before the inference timing
    del state, data
    gc.collect()
    torch.cuda.empty_cache()
    return info


def phase_train_nano() -> dict:
    """(c) One NANO train step on the card (K1 at four scales, K2 at two,
    both backward through autograd.Function) against the same step on the
    CPU."""
    cpu = _calibrated_state(cvm.NANO, seed=3, device="cpu")
    gpu = TLOOP.create_train_state(cvm.NANO, seed=3)
    gpu.model.load_state_dict(cpu.model.state_dict())
    # NANO's aerial image is 128 px wide
    data = _normalized(_train_batch(cvm.NANO, 4, seed=5, device="cpu", span=40.0))
    step = TLOOP.make_train_step(cvm.NANO)
    MC.reset_launch_counts()
    g_parts = step(gpu, {k: v.cuda() for k, v in data.items()})
    torch.cuda.synchronize()
    launches = dict(MC.LAUNCHES)
    if launches != {"matching_epilogue": 4, "matching_scores": 2}:
        raise AssertionError(f"NANO train step launched {launches}, want K1 4 and K2 2")
    c_parts = step(cpu, data)
    info = {"phase": "train_nano", "tolerance": NANO_TRAIN_TOL, "launches": launches,
            **_compare_steps("NANO train step card vs CPU", gpu, cpu, g_parts, c_parts,
                             NANO_TRAIN_TOL)}
    emit(info)
    return info


MATCHING_BACKWARD = ("_EpilogueFnBackward", "_ScoresFnBackward")


def split_step_profile(events, attr: str) -> dict:
    """Time of one profiled train step by part, in ``attr`` (the events'
    ``device_time_total`` on the card): the forward and loss and the
    optimizer (their profiler ranges in ``train.loop``), the matching
    backward (autograd of the plain versions under the kernels'
    ``autograd.Function`` nodes, outermost event only), and the rest of the
    backward as what remains of the step's kernel time."""
    cpu = [e for e in events if e.device_type == torch.autograd.DeviceType.CPU]

    def outermost(names):
        picked = []
        for e in cpu:
            if e.name.endswith(names):
                parent = e.cpu_parent
                while parent is not None and not parent.name.endswith(names):
                    parent = parent.cpu_parent
                if parent is None:
                    picked.append(e)
        return picked

    def total(evts):
        return sum(getattr(e, attr) for e in evts) / 1e3

    # every kernel is attached to the one op that launched it
    step = sum(k.duration for e in cpu for k in e.kernels) / 1e3
    fwd = total(outermost((TLOOP.FORWARD_RANGE,)))
    opt = total(outermost((TLOOP.OPTIMIZER_RANGE,)))
    mbwd = outermost(MATCHING_BACKWARD)
    parts = {"forward_and_loss": fwd, "matching_backward": total(mbwd),
             "optimizer": opt}
    parts["rest_of_backward"] = step - sum(parts.values())
    return {"step": step, **parts, "matching_backward_nodes": len(mbwd)}


def _train_profile(state, batch, gen, dev: dict, out: Path | None) -> dict:
    """(d) ``torch.profiler`` over one train step: device ms by part and the
    top kernels."""
    from torch.profiler import ProfilerActivity, profile

    step = TLOOP.make_train_step(cvm.VIGOR)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    split = split_step_profile(prof.events(), "device_time_total")
    if split["matching_backward_nodes"] != 6 or not split["matching_backward"] > 0:
        raise AssertionError(f"the profile shows {split['matching_backward_nodes']} matching "
                             f"backward nodes with {split['matching_backward']} device ms")
    events = prof.key_averages()
    # kernels only: a profiler range also shows as a device-side span
    ranges = {e.name for e in prof.events() if e.device_type == torch.autograd.DeviceType.CPU}
    rows = sorted(((e.key, e.device_time_total / 1e3, e.count) for e in events
                   if e.device_time_total > 0 and e.device_type == torch.autograd.DeviceType.CUDA
                   and e.key not in ranges),
                  key=lambda r: -r[1])
    if out is not None:
        (out / "train_profile.txt").write_text(
            events.table(sort_by="device_time_total", row_limit=60))
        prof.export_chrome_trace(str(out / "train_trace.json"))
    info = {"phase": "train_profile", "card": dev["nvidia_smi"], "device_ms": split,
            "top": [{"kernel": k[:90], "ms": ms, "launches": c} for k, ms, c in rows[:15]]}
    emit(info)
    return info


def phase_timing(dev: dict, model: api.CVMModel, out: Path | None) -> dict:
    grd, sat = _images(model.cfg, BATCH, seed=6)
    res = {"phase": "timing", "card": dev["nvidia_smi"], "batch": BATCH, "dtype": "float32"}
    for label, tf32 in (("tf32_off", False), ("cudnn_tf32_default", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        for _ in range(3):
            model.predict_batch(grd, sat)
        torch.cuda.synchronize()
        n = 10
        t0 = time.perf_counter()
        for _ in range(n):
            model.predict_batch(grd, sat)
        dt = time.perf_counter() - t0
        fwd = time_ms(lambda: model.forward_readout(grd, sat), reps=10, warmup=1)
        smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,power.draw,temperature.gpu",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip()
        res[label] = {"pairs_per_s": BATCH * n / dt, "predict_batch_ms": dt / n * 1e3,
                      "forward_readout_ms": fwd, "after": smi}
    torch.backends.cudnn.allow_tf32 = False
    res["profile"] = _profile(model, grd, sat, out)
    emit(res)
    return res


def _profile(model, grd, sat, out: Path | None) -> dict:
    from torch.profiler import ProfilerActivity, profile

    model.predict_batch(grd, sat)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(3):
            model.predict_batch(grd, sat)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    events = prof.key_averages()
    attr = "device_time_total" if hasattr(events[0], "device_time_total") else "cuda_time_total"
    rows = sorted(((e.key, getattr(e, attr) / 3e3, e.count / 3) for e in events
                   if getattr(e, attr) > 0 and e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    if out is not None:
        (out / "profile.txt").write_text(events.table(sort_by=attr, row_limit=60))
        prof.export_chrome_trace(str(out / "trace.json"))
    mine = [r for r in rows if any(k in r[0] for k in
                                   ("match_row_kernel", "match_warp_kernel", "match_tile_kernel",
                                    "match_scores_tile_kernel"))]
    return {"device_ms_per_call": busy, "wall_ms_per_call_profiled": wall_ms,
            "matching_kernels_ms_per_call": sum(r[1] for r in mine),
            "matching_kernel_launches_per_call": sum(r[2] for r in mine),
            "top": [{"kernel": k[:90], "ms_per_call": ms, "launches_per_call": c}
                    for k, ms, c in rows[:15]]}


def _deadline(signum, frame):
    raise TimeoutError(f"chip_smoke.py passed its {DEADLINE_S} s deadline")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", type=Path, default=None,
                    help="also write the ptxas report, all numbers and the profile here")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device; this smoke runs on the GPU only",
              file=sys.stderr)
        return 1
    signal.signal(signal.SIGALRM, _deadline)
    signal.alarm(DEADLINE_S)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    dev = phase_device()
    phase_build(args.out)
    kern = phase_kernels(dev)
    model, net = phase_model(dev)
    train = phase_train(dev, args.out)
    timing = phase_timing(dev, net, args.out)
    summary = kern["summary"]
    per = model["launches_per_setting"]   # (K1, K2) per setting
    by_path = {"predict_batch": model["launches"]["matching_epilogue"],
               "train_step": train["launches"]["matching_epilogue"]}
    summary[0]["launches"] = sum(by_path.values())
    summary[0]["launches_by_path"] = by_path
    summary[0]["backward"] = "autograd through the plain version"
    summary[0]["backward_ms_per_train_step"] = train["profile"]["device_ms"]["matching_backward"]
    summary[1]["launches"] = per[json.dumps(dict(ori_noise=36.0))][1]
    summary[2]["launches"] = per[json.dumps(dict(fov=180.0))][1]
    if summary[1]["launches"] + summary[2]["launches"] != model["launches"]["matching_scores"]:
        raise AssertionError(f"K2 launches {model['launches']} are not the prior's and "
                             f"fov=180's ({summary[1]['launches']}, {summary[2]['launches']})")
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"device": dev, "kernels": kern, "model": model, "train": train, "timing": timing,
             "seconds": time.perf_counter() - t0}, indent=1))
    emit({"kernels": summary})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
