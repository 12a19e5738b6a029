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
   time the card could take; then both kernels in bfloat16 at the VIGOR,
   KITTI and Oxford shapes of the bfloat16 paths (bound at 2 bytes per
   element and the tensor cores' bfloat16 rate, ``torch.bmm`` in bfloat16
   beside it), each timed shape also checked against the plain version.
4. model:   ``ccvpe_torch.api.load_model(preset="VIGOR", seed=0)`` on the
   card; ``predict_batch`` at batch 8 with ``ori_noise`` 180 and 36 and with
   ``fov=180``, counting kernel launches by kernel and by layout (K1: tile
   at the three fine scales; K2 at fov=180: tile at four, warp at two), held
   against the same model with matching forced to the plain versions; and a
   NANO model on the card held against the same model on the CPU.
   model_presets: the KITTI (16 bins, 2048-d descriptor; with and without
   a +-2-bin prior) and Oxford RobotCar (4x7 ground grid, centred window)
   presets at full width, batch 8, through the kernels against the plain
   versions (the same pose per sample), launches per kernel and layout,
   and each kernel timed at each of the preset's shapes.
5. train:   the VIGOR train step (``ccvpe_torch.train.loop``) at batch 8 in
   float32, TF32 off, on seeded weights with calibrated BN statistics and
   GT synthesized on the card: (a) one step through K1 against the same
   step through the plain versions (loss parts, every gradient, the new BN
   statistics; 6 K1 launches, 3 tile and 3 warp); (b) 2 warm-up and 5 timed
   steps with drop-connect (finite losses, everything moved, samples/s,
   peak memory); (c) one NANO step on the card against the CPU; (d) the
   device time of one step by part (forward, matching backward, rest of
   the backward, optimizer) and by kernel (``torch.profiler``).
   train_options: the training options on the same VIGOR step (batch 8,
   TF32 off): (a) one bfloat16 step through K1 against the same step
   through the plain versions, cuDNN deterministic, every loss part,
   gradient and BN statistic within ``BF16_TRAIN_TOL`` (set from these
   kernel-vs-plain readings, which it prints first), K1's bfloat16 launches
   by layout exactly; (b) remat 'all',
   'encoder' and 'decoder' against no remat with drop-connect on (loss
   parts 1e-6, gradients, BN, the generator's end state); (c) three steps
   of bfloat16 parameters with the float32 master (each resident
   parameter ``bf16(p + (m - p))`` as optax leaves it; the elements off
   the rounded master counted); (d) step ms and peak memory of float32,
   bfloat16, bfloat16 with bfloat16 parameters and each remat scope.
   data:    the input pipeline on synthetic dataset roots written from
   seeds (``write_roots``; VIGOR's cross-area train split: 48 2048x1024 JPEG
   panoramas and 640x640 PNG tiles over two cities): ``VigorIndex`` ->
   ``VigorSampler`` -> ``Loader`` (8 threads) -> ``device_prefetch`` ->
   ``vigor.device_batch`` on the card ->
   ``make_train_step`` for one epoch of six steps; the loader's batches/s
   alone, the fed step against a resident batch's, the card's idle share
   over each (``torch.profiler``), the host-to-device bytes per batch; one
   batch on the card against the CPU, the prefetched batch against the
   synchronous one; one KITTI batch through the alignment chain on the card
   against the CPU; one Oxford batch; the native decoder's batch path when
   it builds (else its build error).
   cli:     the port's CLIs through ``main([...])`` on those roots, full
   width, batch 8, float32: ``ccvpe_torch.train_VIGOR`` trains an epoch of
   3 steps (validation included), checkpoints (bytes, save ms, the sidecar),
   resumes a second epoch with the restored model and Adam state checked bit
   for bit against the file (restore ms), writes the reference's results
   files; its model, saved with ``CVMModel.save_torch``, evaluates at
   ``--ori_noise 180`` (the shipped frozen orientations), ``36`` and ``-f 180
   --ori_noise 0``; ``train_KITTI`` (``--device_augment``) and
   ``train_OxfordRobotCar`` train 2 steps and evaluate (KITTI's test1/test2,
   Oxford's three traversals).  Every eval runs through the kernels and
   again through the plain versions: the same pixel for every sample, equal
   distances, prob_at_gt within 1e-6, heading within 0.1 degree; launches
   by layout, train and eval pairs/s, and the card's idle share over one
   eval pass (``torch.profiler``).  Then the training options:
   ``train_VIGOR --bf16 --bf16_params --remat --pretrained_b0`` (a B0 file
   written from the port's seeded encoder) trains 2 steps, checkpoints and
   resumes bit for bit (the float32 master included); ``api.load_model`` of
   that checkpoint directory serves through the kernels against the plain
   versions; ``train_KITTI --device_augment --bf16`` and
   ``train_OxfordRobotCar --bf16`` train 2 steps each (K2, and KITTI's K1
   at 256^2 x 32, in bfloat16 inside a model): finite losses, the exact
   bfloat16 launches by kernel and layout of their train steps, peak memory.
6. timing:  steady-state ``predict_batch`` pairs/s at batch 8 in float32,
   and the device time by kernel of three calls (``torch.profiler``).
7. serve:   ``ccvpe_torch.serve`` on 127.0.0.1 with the ``model`` phase's
   VIGOR model at batch 8, ``max_wait_ms`` 5: 96 ``/predict`` requests from
   16 client threads over the keys (180, 360), (36, 360) and (180, 180),
   PNGs at model size and three at a raw size; every answer against
   ``predict_batch`` through the plain versions (the same pixel, heading
   0.1 degree, probability 1e-6); a 413 and a 408; requests/s, latency,
   dispatches and batch fill, 503s, K1/K2 launches, and the card's idle
   share under the same load (``torch.profiler``).
8. quant:   int8 post-training quantization of a copy of the ``model``
   phase's VIGOR model (``CVMModel.quantize_int8`` on a seeded batch of two
   pairs; seconds), batch 8: what ``torch._int_mm`` refuses on this card;
   every int8 conv shape's int32 sums (``torch._int_mm`` over the int8
   im2col) against the plain version (a float64 conv), exactly;
   ``predict_batch`` at the serve keys through K1/K2 against the plain
   matching (the same pixel per sample, the ``model`` phase's heatmap and
   heading gates, the other outputs within ``QUANT_FLIP_SHARE`` of the int8
   model's distance from float32; K1/K2 launches and int8 products counted from 0 at each key); the int8
   readout's distance from the float32 model's (not gated); int8 against
   float32 pairs/s in turns with TF32 off and on; peak memory; device ms by
   part (int8 products, the int8 conv's other passes, K1+K2, the rest) of
   both models;
   ``python -m ccvpe_torch.serve --quantize int8 --calib_dir`` (through
   ``serve.main`` on the same weights) answering 48 requests, each equal to
   the served model's own ``predict_batch``; requests/s.

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
import os
import re
import signal
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from ccvpe_torch import api
from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.models import cvm
from ccvpe_torch.nn import layers as TL
from ccvpe_torch.nn import quant as TQ
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.ops import _build
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC
from ccvpe_torch.train import loop as TLOOP

DEADLINE_S = 1100   # the whole run, build included, must end well inside 1200 s
BATCH = 8

# Published peaks (NVIDIA data sheets, dense, at the full power limit):
# device-memory bytes/s, float32 FLOP/s outside the tensor cores, and
# bfloat16 FLOP/s on the tensor cores (products of bfloat16 inputs summed in
# float32, as both kernels compute them).
PEAKS = {"H100 SXM": (3.35e12, 67e12, 989e12), "H100 PCIe": (2.0e12, 51e12, 756e12),
         "H100 NVL": (3.9e12, 60e12, 835e12)}

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


def peaks_for(name: str) -> tuple[str, float, float, float]:
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
    part, bw, f32, bf16 = peaks_for(name)
    info = {"phase": "device", "nvidia_smi": smi, "name": name,
            "power_limit": smi.split(",")[-1].strip(), "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count,
            "peaks_of": part, "peak_bytes_per_s": bw, "peak_f32_flops": f32,
            "peak_bf16_flops": bf16}
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


def _bound(nbytes: float, flops: float, dev: dict, dtype: str = "float32") -> tuple[float, str]:
    """The least ms for the work: bytes over the memory rate, or operations
    over the peak rate for ``dtype``'s products, whichever is larger."""
    peak = dev["peak_bf16_flops"] if dtype == "bfloat16" else dev["peak_f32_flops"]
    t_bytes, t_ops = nbytes / dev["peak_bytes_per_s"], flops / peak
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def _time_matching(kernel, b, hw, cs, cg, shift, offsets, window, dev: dict, seed,
                   dtype=torch.float32) -> dict:
    """Device ms of ``kernel`` ('K1' or 'K2') in the layout the wrapper
    picks and in every layout that takes the shape, of its plain version and
    of ``torch.bmm`` in ``dtype`` (the product alone, a yardstick), beside
    the bound (bytes at ``dtype``'s size, operations at its peak rate); and
    the picked layout's outputs held against the plain version in float32
    on the same inputs (``max_abs_err``)."""
    x, g = _inputs(b, hw, cs, cg, seed, dtype)
    offsets = tuple(offsets)
    bins = len(offsets)
    pixels = b * hw[0] * hw[1]
    ks = TM.bin_shifts(cs, cg, shift, offsets, window)
    banded = TM._banded(g, cs, ks).to(dtype)            # [B, Cs, bins]
    x3 = x.view(b, -1, cs)
    if kernel == "K1":
        def k_fn(layout=None):
            return MC.launch_matching_epilogue(x, g, shift, offsets, window, layout)
        p_fn = lambda: TM.matching_epilogue_plain(x, g, shift, offsets, window)
        out_elems = pixels * (cs + bins + 1)              # xnorm, scores, smax
        flops = pixels * cs * (2 * bins + 3)              # products, squares, divide
    else:
        def k_fn(layout=None):
            return MC.launch_matching_scores(x, g, shift, offsets, window, layout)
        p_fn = lambda: TM.matching_scores_plain(x, g, shift, offsets, window)
        out_elems = pixels * bins
        # products; squares; masked: a window product per bin
        flops = pixels * cs * (2 * bins + (2 * bins if cg < cs else 2))
    nbytes = x.element_size() * (x.numel() + g.numel() + out_elems)
    bound, by = _bound(nbytes, flops, dev, str(dtype)[6:])
    layout = MC.pick_layout(KERNEL_NAMES[kernel], x, cg, bins)
    plain = (TM.matching_epilogue_plain if kernel == "K1" else TM.matching_scores_plain)(
        x.float(), g.float(), shift, offsets, window)
    got = k_fn()
    torch.cuda.synchronize()
    err = _check(f"{kernel} {layout} x{[b, *hw, cs]} g{[b, cg]} {str(dtype)[6:]} (timed shape)",
                 got if kernel == "K1" else (got,), plain if kernel == "K1" else (plain,), dtype)
    by_layout = {lay: device_ms(lambda lay=lay: k_fn(lay))
                 for lay in _layouts(kernel, x.shape, cg, bins, x.dtype)}
    row = {"kernel": kernel, "dtype": str(dtype)[6:], "x": [b, *hw, cs], "g": [b, cg],
           "bins": bins, "shift": shift,
           "window": window, "layout": layout, "ms": by_layout[layout],
           "ms_by_layout": by_layout, "eager_ms": time_ms(k_fn), "plain_ms": device_ms(p_fn),
           "library_ms": device_ms(lambda: torch.bmm(x3, banded)),
           "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops,
           "max_abs_err": err}
    row["achieved_bytes_per_s"] = nbytes / (row["ms"] * 1e-3)
    return row


def _summary(name, rows, replaces, dev: dict) -> dict:
    """One kernel row of the ``kernels`` line: the sums over ``rows`` (all
    of one dtype), and the largest error of their checks at these shapes."""
    total = {k: sum(r[k] for r in rows) for k in
             ("ms", "eager_ms", "plain_ms", "library_ms", "bound_ms", "bytes", "flops")}
    dtype = rows[0]["dtype"]
    return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "dtype": dtype, "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": total["ms"], "kernel_ms": total["ms"], "eager_ms": total["eager_ms"],
            "plain_ms": total["plain_ms"], "bound_ms": total["bound_ms"],
            "bound_by": _bound(total["bytes"], total["flops"], dev, dtype)[1],
            "library_ms": total["library_ms"],
            "timed_at": "sum over x " + ", ".join(str(r["x"]) for r in rows),
            "layouts": [r["layout"] for r in rows]}


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
        row = _time_matching(kernel, BATCH, hw, cs, cg, shift, range(20), "first", dev, seed)
        if kernel == "K2" and "tile" in row["ms_by_layout"]:
            x, g = _inputs(BATCH, hw, cs, cg, seed, torch.float32)
            row["ms_by_tile_plan"] = _tile_plan_times(x, g, shift)
        shapes.append(row)
        return row

    k1 = [timed("K1", (s, s), cs, cs, shift, 20 + i)
          for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    k2 = [timed("K2", (8, 8), 1280, 1280, 64, 30)]
    # the limited-fov setting: K2 with the masked window at every scale
    k2_fov = [timed("K2", (s, s), cs, cs // 2, shift, 40 + i)
              for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    # bfloat16 at the shapes of the bf16 main paths (train_options, cli):
    # VIGOR's six K1 scales; KITTI's and Oxford's scales (K1 where Cg == Cs)
    bf16 = {"VIGOR": [_time_matching("K1", BATCH, (s, s), cs, cs, shift, range(20), "first", dev,
                                     70 + i, torch.bfloat16)
                      for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]}
    for preset in ("KITTI", "OxfordRobotCar"):
        pc = cvm.PRESETS[preset]
        bf16[preset] = [_time_matching("K1" if cg == cs else "K2", BATCH, (side, side), cs, cg,
                                       shift, range(pc.bins), pc.window, dev, 80 + i,
                                       torch.bfloat16)
                        for i, (side, cs, cg, shift) in enumerate(preset_scales(pc))]
    emit({"phase": "kernel_times", "card": dev["nvidia_smi"], "shapes": shapes,
          "bfloat16": bf16})

    def summary(name, rows, kernel, replaces):
        return _summary(name, rows, replaces, dev)

    bf16_rows = []
    for preset, rows in bf16.items():
        for kernel in ("K1", "K2"):
            mine = [r for r in rows if r["kernel"] == kernel]
            if mine:
                bf16_rows.append(summary(f"{KERNEL_NAMES[kernel]} ({kernel}), {preset} bf16",
                                         mine, kernel, K1_REPLACES if kernel == "K1"
                                         else K2_REPLACES))

    # K2 in two rows: its one launch per ori-prior forward (the full-bin
    # bottleneck stack) and its six per fov=180 forward (masked windows), so
    # that each row's ms and launches describe the same work
    return {"checks": checks, "shapes": shapes, "bf16_shapes": bf16, "bf16_summary": bf16_rows,
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
    launches = dict.fromkeys(MC.launch_counts(), 0)
    for kw, _ in settings:
        MC.reset_launch_counts()
        poses.append(model.predict_batch(grd, sat, return_heatmap=True, **kw))
        counts = MC.launch_counts()
        steps.append((counts["matching_epilogue"], counts["matching_scores"]))
        layout_steps.append({k: n for k, n in MC.launch_counts("layout").items() if n})
        for k in launches:
            launches[k] += counts[k]
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
    before = sum(MC.launch_counts().values())
    errs = {}
    for kw in (dict(ori_noise=180.0), dict(ori_noise=36.0, fov=180.0)):
        out, r = gpu.forward_readout(grd, sat, **kw)
        ref, rr = cpu.forward_readout(grd, sat, **kw)
        errs[json.dumps(kw)] = _compare(f"NANO {kw}", out, ref, r, rr, tol)
    n = sum(MC.launch_counts().values()) - before
    if n != 13:    # 6 + (6 + the full-bin bottleneck stack)
        raise AssertionError(f"NANO launched the kernels {n} times, want 13")
    info = {"phase": "nano_reference", "tolerance": tol, "max_abs_err": errs}
    emit(info)
    return info


# the two other presets at full width: KITTI with and without a +-2-bin prior
# (36 degrees: two bins of 18), Oxford RobotCar without
PRESET_SETTINGS = {"KITTI": (dict(ori_noise=180.0), dict(ori_noise=36.0)),
                   "OxfordRobotCar": (dict(ori_noise=180.0),)}


def preset_scales(cfg) -> list[tuple[int, int, int, int]]:
    """(side, Cs, Cg, shift) of each matching scale of ``cfg``: the aerial
    descriptor grid is 8x8 and doubles per scale; Cs is the descriptor's
    width, then each localization stage's; Cg the ground descriptor's."""
    cs = (cfg.sat_desc_dim, *cfg.loc_conv_ch)
    return [(8 * 2 ** s, cs[s], cfg.grd_desc_len[s], cfg.shifts[s]) for s in range(6)]


def phase_model_presets(dev: dict) -> dict:
    """One forward of the KITTI and the Oxford preset per setting at batch 8,
    float32, TF32 off, on seeded BN-calibrated weights, through the kernels
    and through the plain versions (K1 where Cg == Cs, K2 elsewhere: KITTI's
    16 bins, 2048-d descriptor and first window; Oxford's 4x7 ground grid and
    centred window); then each kernel at each of the preset's shapes, timed."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "model_presets", "card": dev["nvidia_smi"], "batch": BATCH,
            "dtype": "float32", "tolerance": MODEL_TOL, "presets": {}}
    for preset, settings in PRESET_SETTINGS.items():
        model = api.load_model(preset=preset, seed=0)
        _calibrate(model, seed=1)
        plain = api.CVMModel(model.cfg, model.net, model.device, matching_impl="plain")
        grd, sat = _images(model.cfg, BATCH, seed=2)
        scales = preset_scales(model.cfg)
        n_k1 = sum(cg == cs for _, cs, cg, _ in scales)
        results = []
        for kw in settings:
            prior = kw["ori_noise"] < 180
            MC.reset_launch_counts()
            poses = model.predict_batch(grd, sat, return_heatmap=True, **kw)
            launches = MC.launch_counts()
            by_layout = {f"{k} {lay}": n for (k, lay), n in MC.launch_counts("layout").items() if n}
            want = {"matching_epilogue": n_k1, "matching_scores": 6 - n_k1 + prior}
            if launches != want:
                raise AssertionError(f"{preset} {kw}: launches {launches}, want {want}")
            out, r = model.forward_readout(grd, sat, return_heatmap=True, **kw)
            ref, rr = plain.forward_readout(grd, sat, return_heatmap=True, **kw)
            errs = _compare(f"{preset} {kw}", out, ref, r, rr, MODEL_TOL)
            heading = 0.0
            for p, q in zip(poses, plain.predict_batch(grd, sat, return_heatmap=True, **kw)):
                if (p.row, p.col) != (q.row, q.col):
                    raise AssertionError(f"{preset} {kw}: pose differs: {p} vs {q}")
                if not (0 <= p.probability <= 1 and np.isfinite(p.orientation_deg)):
                    raise AssertionError(f"{preset} {kw}: bad pose {p}")
                heading = max(heading, abs((p.orientation_deg - q.orientation_deg + 180) % 360
                                           - 180))
            if heading > HEADING_TOL_DEG:
                raise AssertionError(f"{preset} {kw}: heading differs by {heading} deg")
            results.append({"setting": kw, "launches": launches, "launches_by_layout": by_layout,
                            "rows": [p.row for p in poses], "cols": [p.col for p in poses],
                            "max_abs_err": errs, "heading_err_deg": heading,
                            "logit_spread_min": out.logits_flattened.std(dim=1).min().item()})
        times = [_time_matching("K1" if cg == cs else "K2", BATCH, (side, side), cs, cg, shift,
                                range(model.cfg.bins), model.cfg.window, dev, 60 + i)
                 for i, (side, cs, cg, shift) in enumerate(scales)]
        info["presets"][preset] = {"results": results, "times": times}
        del model, plain
        gc.collect()
        torch.cuda.empty_cache()
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
    worst, worst_rel, n = 0.0, 0.0, 0
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
        worst_rel = max(worst_rel, d / max(q.grad.float().norm().item(), 1e-30))
    theirs = dict(want.model.named_buffers())
    bn_err = 0.0
    for k, v in got.model.named_buffers():
        if k.endswith(("running_mean", "running_var")):
            torch.testing.assert_close(v.cpu(), theirs[k].cpu(), atol=tol["bn"], rtol=tol["bn"],
                                       msg=lambda m, k=k: f"{tag}: {k}: {m}")
            bn_err = max(bn_err, (v.cpu() - theirs[k].cpu()).abs().max().item())
    return {"loss_parts_rel_err": errs, "gradient_tensors": n,
            "worst_gradient_err_over_limit": worst, "worst_gradient_rel_err": worst_rel,
            "bn_max_abs_err": bn_err}


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
    k_layouts = {k: n for k, n in MC.launch_counts("layout").items() if n}
    p_parts = TLOOP.make_train_step(cfg, matching_impl="plain")(plain, _normalized(data))
    torch.cuda.synchronize()
    want_layouts = {("matching_epilogue", "tile"): 3, ("matching_epilogue", "warp"): 3}
    if k_layouts != want_layouts:
        raise AssertionError(f"VIGOR train step: launches by layout {k_layouts}, "
                             f"want {want_layouts}")
    if sum(MC.launch_counts().values()) != 6:
        raise AssertionError(f"the plain step launched a kernel: {MC.launch_counts()}")
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
    launches = MC.launch_counts()
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
    launches = MC.launch_counts()
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


# train_options: the remat steps against the step without remat (float32,
# drop-connect on): the same forward, so the loss parts agree to rounding;
# cuDNN's weight gradients may sum in another order on each run
REMAT_TOL = {"loss_rtol": 1e-6, "grad_rel": 1e-4, "grad_abs": 1e-7, "bn": 1e-6}
OPTION_STEPS = 3          # timed steps per configuration, after one warm-up
# the bf16 VIGOR step through K1 against the same bf16 step through the
# plain versions, cuDNN deterministic: the kernel's and the plain version's
# outputs differ by up to one bf16 rounding (BF16_TOL) and the bf16
# backward carries that on.  Set from the kernel-vs-plain readings on an
# H100 (phase train_options_bf16_readings): loss parts <= 1.6e-4 relative
# (grad_norm; the loss 1.9e-6); per gradient tensor up to 0.68 of its own
# 2-norm (the encoders' BN biases, whose gradients are near zero and pure
# bf16 noise: 50-280 against f32 norms under 0.005) and up to 5.7e-3 of the
# step's gradient norm; BN statistics equal.
BF16_TRAIN_TOL = {"loss_rtol": 1e-3, "grad_rel": 5e-2, "grad_abs": 2e-2, "bn": 1e-6}


def _step_distance(got, want, got_parts, want_parts) -> dict:
    """How far one step lies from another from the same start: each loss
    part, relative; the five gradient tensors furthest off relative to their
    own 2-norm ([distance, norm]); the largest distance over the step's
    gradient norm."""
    theirs = dict(want.model.named_parameters())
    dist = {k: ((p.grad.float() - theirs[k].grad.float()).norm().item(),
                theirs[k].grad.float().norm().item())
            for k, p in got.model.named_parameters() if p.grad is not None}
    worst = sorted(dist, key=lambda k: dist[k][0] / max(dist[k][1], 1e-30), reverse=True)[:5]
    return {"loss_parts_rel": {k: abs(got_parts[k].item() - v.item()) / abs(v.item())
                               for k, v in want_parts.items()},
            "worst_gradient_rel": {k: list(dist[k]) for k in worst},
            "worst_gradient_over_grad_norm": max(d for d, _ in dist.values())
            / want_parts["grad_norm"].item()}


def _timed_steps(state, step, batch, gen) -> dict:
    """Step ms (CUDA events over OPTION_STEPS steps after one warm-up), the
    peak memory allocated during them, and one more step under
    ``torch.profiler``: the card's busy ms and the kernels it ran."""
    from torch.profiler import ProfilerActivity, profile

    step(state, batch, gen)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batch, gen)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    busy_ms, _ = _busy_ms(prof.events())
    kernels = sum(1 for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA)
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    parts = [step(state, batch, gen) for _ in range(OPTION_STEPS)]
    b.record()
    b.synchronize()
    if not all(math.isfinite(v.item()) for p in parts for v in p.values()):
        raise AssertionError(f"non-finite loss parts: {parts}")
    step_ms = a.elapsed_time(b) / OPTION_STEPS
    return {"step_ms": step_ms,
            "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_over_resident_gib": (torch.cuda.max_memory_allocated() - resident) / 2 ** 30,
            "profiled_busy_ms": busy_ms, "profiled_wall_ms": prof_wall,
            "device_ops_per_step": kernels, "idle_share": 1 - busy_ms / step_ms}


def _dtype_launches() -> dict:
    return {f"{k} {d}": n for (k, d), n in MC.launch_counts("dtype").items() if n}


def _bf16_layout_launches() -> dict:
    return {f"{k} {lay}": n for (k, lay, d), n in MC.launch_counts("layout", "dtype").items()
            if n and d == "bfloat16"}


def _bf16_launches(cfg, steps: int = 1, batch: int = BATCH) -> dict:
    """The bf16 launches by (kernel, layout) of ``steps`` train steps of
    ``cfg`` at ``batch`` (forwards without a prior): K1 where Cg == Cs, K2
    elsewhere, each in the layout its wrapper picks at that scale."""
    want: dict = {}
    for side, cs, cg, _ in preset_scales(cfg):
        kernel = KERNEL_NAMES["K1" if cg == cs else "K2"]
        x = torch.empty((batch, side, side, cs), dtype=torch.bfloat16, device="cuda")
        key = f"{kernel} {MC.pick_layout(kernel, x, cg, cfg.bins)}"
        want[key] = want.get(key, 0) + steps
    return want


def phase_train_options(dev: dict) -> dict:
    """The training options on the VIGOR train step at full width, batch 8,
    TF32 off, from one seeded state with calibrated BN statistics: (a) one
    bf16 step through K1 against the same bf16 step through the plain
    versions (the bar from the float32 step); (b) remat 'all', 'encoder'
    and 'decoder' against no remat, drop-connect on; (c) three steps of
    bf16 parameters with the float32 master; (d) step ms and peak memory of
    each configuration."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cvm.VIGOR
    t_phase = time.perf_counter()
    base = _calibrated_state(cfg, seed=0)
    data = _normalized(_train_batch(cfg, BATCH, seed=2, device="cuda"))
    info = {"phase": "train_options", "card": dev["nvidia_smi"], "preset": cfg.name,
            "batch": BATCH}

    # (a) bf16 through K1 against bf16 through the plain versions, cuDNN
    # deterministic: the two steps differ by the kernel's outputs alone
    ref, plain, kern = (copy.deepcopy(base) for _ in range(3))
    torch.backends.cudnn.deterministic = True
    r_parts = TLOOP.make_train_step(cfg, matching_impl="plain")(ref, data)
    p_parts = TLOOP.make_train_step(cfg, matching_impl="plain", compute_dtype="bfloat16")(
        plain, data)
    MC.reset_launch_counts()
    k_parts = TLOOP.make_train_step(cfg, compute_dtype="bfloat16")(kern, data)
    torch.cuda.synchronize()
    torch.backends.cudnn.deterministic = False
    readings = _step_distance(kern, plain, k_parts, p_parts)
    emit({"phase": "train_options_bf16_readings", "kernel_vs_plain": readings,
          "bf16_vs_float32": _step_distance(plain, ref, p_parts, r_parts)})
    layouts = _bf16_layout_launches()
    by_dtype = _dtype_launches()
    want_bf16 = _bf16_launches(cfg)
    if layouts != want_bf16 or sum(by_dtype.values()) != sum(want_bf16.values()):
        raise AssertionError(f"bf16 {cfg.name} step launched {by_dtype} {layouts}, "
                             f"want {want_bf16}")
    info["bf16_kernel_vs_plain"] = {
        **_compare_steps(f"{cfg.name} bf16 step kernel vs plain", kern, plain, k_parts, p_parts,
                         BF16_TRAIN_TOL),
        "tolerance": BF16_TRAIN_TOL, "readings": readings,
        "launches_by_layout": layouts, "launches_by_dtype": by_dtype,
        "loss": {k: v.item() for k, v in k_parts.items()},
        "loss_float32": {k: v.item() for k, v in r_parts.items()}}
    bf16_launches = by_dtype.get("matching_epilogue bfloat16", 0)
    del ref, plain, kern
    torch.cuda.empty_cache()

    # (b) each remat scope against no remat, drop-connect on, float32
    gen = torch.Generator(device="cuda").manual_seed(7)
    want = copy.deepcopy(base)
    w_parts = TLOOP.make_train_step(cfg)(want, data, gen)
    info["remat"] = {}
    for scope in ("all", "encoder", "decoder"):
        got = copy.deepcopy(base)
        g2 = torch.Generator(device="cuda").manual_seed(7)
        g_parts = TLOOP.make_train_step(cfg, remat=scope)(got, data, g2)
        torch.cuda.synchronize()
        if not torch.equal(g2.get_state(), gen.get_state()):
            raise AssertionError(f"remat {scope}: the generator ends elsewhere")
        info["remat"][scope] = _compare_steps(f"remat {scope} vs none", got, want, g_parts,
                                              w_parts, REMAT_TOL)
        del got
    del want
    torch.cuda.empty_cache()

    # (c) bf16 parameters with the float32 master: three steps through K1
    state = TLOOP.train_state_from_torch(base.model.state_dict(), cfg, param_dtype="bfloat16")
    step = TLOOP.make_train_step(cfg, compute_dtype="bfloat16")
    opt = state.optimizer
    MC.reset_launch_counts()
    losses = [step(state, data, gen)["loss"].item() for _ in range(2)]
    before = [p.detach().clone() for p in opt.params]
    losses.append(step(state, data, gen)["loss"].item())
    torch.cuda.synchronize()
    master_launches = _bf16_layout_launches()
    if master_launches != _bf16_launches(cfg, steps=3):
        raise AssertionError(f"three bf16-parameter steps launched {master_launches}")
    bf16_launches += MC.launch_counts("dtype")["matching_epilogue", "bfloat16"]
    # the resident parameter is what optax.apply_updates leaves, bf16(p + (m - p))
    # in float32: the rounded master, except where m - p rounds (a parameter
    # that moved far relative to its size, e.g. across zero): there the sum
    # is off m by a float32 ulp of p, and its rounding may leave bf16(m)
    formula, exact, off, worst = 0, 0, 0, 0.0
    for p, m, q in zip(opt.params, opt.master, before):
        qf = q.float()
        formula += torch.equal(p, (qf + (m - qf)).to(torch.bfloat16))
        rounded = m.to(torch.bfloat16)
        exact += torch.equal(p, rounded)
        miss = p != rounded
        off += int(miss.sum())
        if miss.any():
            ulp = (rounded.float().abs() * 2.0 ** -7)[miss]
            worst = max(worst, ((p.float() - rounded.float()).abs()[miss] / ulp).max().item())
    if formula != len(opt.params) or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"bf16 params: {formula} of {len(opt.params)} follow "
                             f"bf16(p + (m - p)); {off} elements off the rounded master by "
                             f"up to {worst} ulp; losses {losses}")
    info["bf16_params"] = {"losses": losses, "params": len(opt.params),
                           "with_gradient": sum(p.grad is not None for p in opt.params),
                           "resident_follows_apply_updates": formula,
                           "resident_equals_rounded_master": exact,
                           "elements_off_rounded_master": off, "worst_off_ulp": worst,
                           "elements": sum(p.numel() for p in opt.params)}
    del state, step, opt
    torch.cuda.empty_cache()

    # (d) step ms and peak memory per configuration, drop-connect on
    configs = {"float32": ({}, None), "bf16": (dict(compute_dtype="bfloat16"), None),
               "bf16+bf16_params": (dict(compute_dtype="bfloat16"), "bfloat16"),
               "remat_all": (dict(remat="all"), None),
               "remat_encoder": (dict(remat="encoder"), None),
               "remat_decoder": (dict(remat="decoder"), None)}
    info["timing"] = {}
    MC.reset_launch_counts()
    for name, (kw, param_dtype) in configs.items():
        state = (TLOOP.train_state_from_torch(base.model.state_dict(), cfg,
                                              param_dtype=param_dtype)
                 if param_dtype else copy.deepcopy(base))
        info["timing"][name] = _timed_steps(state, TLOOP.make_train_step(cfg, **kw), data, gen)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    bf16_launches += MC.launch_counts("dtype")["matching_epilogue", "bfloat16"]
    info["launches_bf16_k1"] = bf16_launches
    info["seconds"] = time.perf_counter() - t_phase
    emit(info)
    del base, data
    gc.collect()
    torch.cuda.empty_cache()
    return info


DATA_TOL = 1e-6           # a device batch on the card against the same batch on the CPU
FED_STEPS = 6             # one epoch of the synthetic VIGOR root: 48 panoramas, batch 8
DATA_ROUNDS = 3           # fed and resident epochs, in turns


def _busy_ms(events) -> tuple[float, float]:
    """(busy ms, span ms) of the card in a profile: the union of the
    intervals of its kernels and copies, and the time from the first one's
    start to the last one's end.  A profiler range also shows as a span on
    the device; those are left out."""
    cpu = {e.name for e in events if e.device_type == torch.autograd.DeviceType.CPU}
    spans = sorted((e.time_range.start, e.time_range.end) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA and e.name not in cpu)
    busy, cur_start, cur_end = 0.0, None, None
    for a, b in spans:
        if cur_end is None or a > cur_end:
            if cur_end is not None:
                busy += cur_end - cur_start
            cur_start, cur_end = a, b
        else:
            cur_end = max(cur_end, b)
    if cur_end is not None:
        busy += cur_end - cur_start
    return busy / 1e3, (spans[-1][1] - spans[0][0]) / 1e3 if spans else 0.0


def _steps(state, step, batches, gen, profiled: bool) -> dict:
    """Train steps over ``batches``; the first is a warm-up, the rest are
    timed between two CUDA events (device time per step, waits for data
    included) and, when ``profiled``, traced for the card's idle share."""
    from torch.profiler import ProfilerActivity, profile

    it = iter(batches)
    parts = [step(state, next(it), gen)]
    torch.cuda.synchronize()
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled else None
    if prof is not None:
        prof.__enter__()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    w0 = time.perf_counter()
    a.record()
    n = 0
    for batch in it:
        parts.append(step(state, batch, gen))
        n += 1
    b.record()
    b.synchronize()
    wall = time.perf_counter() - w0
    res = {"steps": n + 1, "timed_steps": n, "step_ms": a.elapsed_time(b) / n,
           "wall_step_ms": wall / n * 1e3, "losses": [p["loss"].item() for p in parts]}
    if prof is not None:
        prof.__exit__(None, None, None)
        busy, span = _busy_ms(prof.events())
        res.update(busy_ms_per_step=busy / n, profiled_span_ms=span,
                   idle_share_profiled=1 - busy / span)
    if not all(math.isfinite(v) for v in res["losses"]):
        raise AssertionError(f"non-finite losses {res['losses']}")
    return res


def _check_batch(tag, got: dict, want: dict, tol: float) -> dict:
    errs = {}
    for k, v in want.items():
        g = got[k]
        if g.device.type != "cuda" or g.shape != v.shape or not torch.isfinite(g).all():
            raise AssertionError(f"{tag}: {k} {g.device} {tuple(g.shape)} vs {tuple(v.shape)}")
        errs[k] = (g.cpu() - v).abs().max().item()
        if not errs[k] <= tol:
            raise AssertionError(f"{tag}: {k} differs from the CPU by {errs[k]} > {tol}")
    return errs


def phase_data(dev: dict, roots: dict) -> dict:
    """The input pipeline of training on the synthetic dataset roots of
    ``write_roots``: VIGOR (2048x1024 JPEG panoramas, 640x640 PNG tiles; the
    cross-area split: 48 panoramas over two cities) through ``VigorIndex`` ->
    ``VigorSampler`` -> ``Loader`` (8 threads) -> ``device_prefetch`` ->
    ``vigor.device_batch`` -> ``make_train_step`` (full width, float32);
    one KITTI batch through the alignment chain on the card; one Oxford
    batch; the native decoder's batch path where it builds."""
    import PIL

    from ccvpe_torch.data import kitti as DK
    from ccvpe_torch.data import native_loader
    from ccvpe_torch.data import oxford as DO
    from ccvpe_torch.data import pipeline as DP
    from ccvpe_torch.data import vigor as DV

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "data", "card": dev["nvidia_smi"], "batch": BATCH, "decode": "PIL",
            "pil": PIL.__version__, "workers": 8, "tolerance": DATA_TOL,
            "root_write_s": roots["write_s"]}
    index = DV.VigorIndex.load(roots["vigor"], "crossarea", train=True)
    sampler = DV.VigorSampler(index, pos_only=False)
    order = DP.epoch_indices(len(index), shuffle=True, rng=np.random.default_rng(0))

    def loader(**kw):
        return DP.Loader(sampler, order, batch_size=BATCH, num_workers=8, **kw)

    # the loader alone: host decode, resize and collation, no device work
    t0 = time.perf_counter()
    hosts = list(loader(native_batch=False))
    loader_s = time.perf_counter() - t0
    if len(hosts) != FED_STEPS:
        raise AssertionError(f"{len(hosts)} batches from {len(index)} panoramas")
    info["loader_batches_per_s"] = len(hosts) / loader_s
    info["loader_ms_per_batch"] = loader_s / len(hosts) * 1e3
    info["h2d_bytes_per_batch"] = sum(v.nbytes for v in hosts[0].values()
                                      if v.dtype.kind in "biuf")

    # one thread's PIL decode and resize of one image of each kind
    from ccvpe_torch.data.transforms import load_image

    def decode_ms(paths, hw):
        times = []
        for p in paths:
            t0 = time.perf_counter()
            load_image(str(p), hw)
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    info["decode_ms"] = {"panorama_2048x1024_jpeg_to_320x640": decode_ms(
                             index.grd_paths[:8], DV.GRD_HW),
                         "tile_640x640_png_to_512x512": decode_ms(
                             index.sat_paths[:8], DV.SAT_HW)}

    # one batch on the card against the same batch on the CPU
    fn = lambda raw: DV.device_batch(raw, train=True, device="cuda")
    sync = fn(hosts[0])
    info["device_batch_max_abs_err"] = _check_batch(
        "VIGOR device batch", sync, DV.device_batch(hosts[0], train=True, device="cpu"),
        DATA_TOL)

    # the main path: steps fed from the root, the batch assembled on the
    # side stream; then the same steps on one resident batch
    state = _calibrated_state(cvm.VIGOR, seed=0)
    step = TLOOP.make_train_step(cvm.VIGOR)
    gen = torch.Generator(device="cuda").manual_seed(7)
    prefetched = {}

    def fed(epoch):
        sampler.set_epoch(epoch)
        for i, batch in enumerate(DP.device_prefetch(loader(native_batch=False), fn,
                                                     device="cuda")):
            if epoch == 0 and i == 0:
                prefetched.update(batch)
            yield batch

    resident = [sync] * FED_STEPS
    fed_ms, resident_ms = [], []
    for r in range(DATA_ROUNDS):      # in turns: fed, resident, fed, ...
        if r == 0:
            MC.reset_launch_counts()
        run = _steps(state, step, fed(r), gen, profiled=False)
        if r == 0:
            launches = MC.launch_counts()
            if launches != {"matching_epilogue": 6 * FED_STEPS, "matching_scores": 0}:
                raise AssertionError(f"{FED_STEPS} fed steps launched {launches}")
            info["launches"] = launches
            info["prefetched_equals_synchronous"] = {
                k: torch.equal(prefetched[k], v) for k, v in sync.items()}
            if not all(info["prefetched_equals_synchronous"].values()):
                raise AssertionError(f"prefetched batch differs: "
                                     f"{info['prefetched_equals_synchronous']}")
            prefetched.clear()
            info["fed_losses"] = run["losses"]
        fed_ms.append(run["step_ms"])
        resident_ms.append(_steps(state, step, resident, gen, profiled=False)["step_ms"])
    info["fed_step_ms"], info["resident_step_ms"] = fed_ms, resident_ms
    info["fed_step_ms_median"] = statistics.median(fed_ms)
    info["resident_step_ms_median"] = statistics.median(resident_ms)
    # the card's idle share: kernel and copy time per step from a
    # profiled epoch over the step time of the unprofiled runs (the
    # profiler slows the host), and the share idle under the profiler
    for name, batches, ms in (("fed", fed(DATA_ROUNDS), fed_ms),
                              ("resident", resident, resident_ms)):
        prof = _steps(state, step, batches, gen, profiled=True)
        prof["idle_share"] = 1 - prof["busy_ms_per_step"] / statistics.median(ms)
        del prof["losses"]
        info[f"{name}_profiled"] = prof
    info["device_batch_ms"] = time_ms(lambda: fn(hosts[0]), reps=5, warmup=1)
    sampler.set_epoch(0)
    del state, sync, resident
    gc.collect()
    torch.cuda.empty_cache()

    # the native decoder's batch path (opt-in, as in the JAX package)
    if native_loader.available():
        t0 = time.perf_counter()
        native = list(loader(native_batch=True))
        native_s = time.perf_counter() - t0
        diff = {k: int(np.abs(a[k].astype(int) - b[k].astype(int)).max())
                for a, b in zip(native[:1], hosts[:1]) for k in ("grd", "sat")}
        for a, b in zip(native, hosts):
            for k in ("rotation", "angle", "row_offset", "col_offset", "city"):
                np.testing.assert_array_equal(a[k], b[k])
            for k in ("grd", "sat"):
                if np.abs(a[k].astype(int) - b[k].astype(int)).mean() >= 1.0:
                    raise AssertionError(f"native {k} differs from PIL's")
        info["native"] = {"ran": True, "batches_per_s": len(native) / native_s,
                          "max_abs_diff_vs_pil_first_batch": diff}
    else:
        info["native"] = {"ran": False, "build_error": native_loader.build_error()}
    del hosts

    # KITTI: ground 1242x375, aerial 1280x1280, the alignment chain on the card
    root = roots["kitti"]
    kidx = DK.KittiIndex.load(root, f"{root}/train_files.txt")
    ks = DK.KittiSampler(kidx, device_augment=True)
    (raw,) = list(DP.Loader(ks, np.arange(BATCH), batch_size=BATCH, num_workers=8))
    kw = dict(train=True, mpp=ks.mpp)
    card = DK.device_batch_device_aug(raw, device="cuda", **kw)
    cpu = DK.device_batch_device_aug(raw, device="cpu", **kw)
    sat = (card["sat"].cpu() - cpu["sat"]).abs()
    # tests/test_data.py:481-504: normalised units within 0.05
    close = (sat < 0.05).float().mean().item()
    if not close > 0.95:
        raise AssertionError(f"KITTI chain on the card agrees with the CPU at {close}")
    info["kitti"] = {
        "sat_raw": list(raw["sat_raw"].shape), "close_share": close,
        "equal_share": (sat.amax(dim=-1) <= DATA_TOL).float().mean().item(),
        "max_abs_err": _check_batch("KITTI device batch",
                                    {k: v for k, v in card.items() if k != "sat"},
                                    {k: v for k, v in cpu.items() if k != "sat"}, DATA_TOL),
        # host arrays in (39 MB of raw tiles copied), device batch out
        "device_batch_ms": time_ms(
            lambda: DK.device_batch_device_aug(raw, device="cuda", **kw), reps=5, warmup=1)}
    del card, cpu, raw

    # Oxford: a 4000x4000 aerial map, 1280x960 ground frames
    root = roots["oxford"]
    oidx = DO.OxfordIndex.load(root, root + "satellite_map_new.png", "train")
    (raw,) = list(DP.Loader(DO.OxfordSampler(oidx), np.arange(BATCH), batch_size=BATCH,
                            num_workers=8))
    card = DO.device_batch(raw, train=True, device="cuda")
    info["oxford"] = {"grd": list(card["grd"].shape), "sat": list(card["sat"].shape),
                      "max_abs_err": _check_batch(
                          "Oxford device batch", card,
                          DO.device_batch(raw, train=True, device="cpu"), DATA_TOL)}
    emit(info)
    gc.collect()
    torch.cuda.empty_cache()
    return info


def write_roots(tmp: str) -> dict:
    """Synthetic dataset roots from seeds in the datasets' layouts and
    published raw sizes, read by the ``data`` and ``cli`` phases: VIGOR
    (four cities of 24 2048x1024 JPEG panoramas and 24 640x640 PNG tiles;
    the cross-area train split, New York and Seattle, is ``data``'s 48),
    KITTI (16 frames of 375x1242 and their 1280x1280 tiles, both test
    splits over all 16), Oxford (a 4000x4000 map, 24 frames of 1280x960,
    three test traversals of 8)."""
    from ccvpe_torch.data import synthetic

    t0 = time.perf_counter()
    roots = {
        "vigor": synthetic.write_vigor_root(
            f"{tmp}/vigor", panos_per_city=24, sats_per_city=24, pano_hw=(1024, 2048),
            sat_hw=(640, 640), pano_ext=".jpg", span=300.0, seed=0),
        "kitti": synthetic.write_kitti_root(f"{tmp}/kitti", n=2 * BATCH, n_test=2 * BATCH,
                                            grd_hw=(375, 1242), sat_hw=(1280, 1280), seed=1),
        "oxford": synthetic.write_oxford_root(f"{tmp}/oxford/", n=3 * BATCH, map_hw=(4000, 4000),
                                              grd_hw=(960, 1280), test_frames=BATCH, seed=2)}
    roots["write_s"] = time.perf_counter() - t0
    return roots


class _CliProbe:
    """While active, records what the CLIs' harness does, without a host
    sync in its loops: each trainer, each train epoch's pairs/s, each
    step's loss (on the card), each eval pass's readout dicts (on the card),
    wall time and pairs/s, each checkpoint save's and restore's ms; each
    resume is checked bit for bit against the file it restored.  With
    ``profile_eval`` set, an eval pass runs under ``torch.profiler`` and its
    busy device ms are kept."""

    def __init__(self):
        self.trainers, self.epochs, self.losses, self.readouts = [], [], [], []
        self.evals, self.saves_ms, self.restores_ms, self.resumes = [], [], [], []
        self.profile_eval = False
        self._undo = []

    def _patch(self, owner, name, wrap):
        orig = getattr(owner, name)
        setattr(owner, name, wrap(orig))
        self._undo.append((owner, name, orig))

    def __enter__(self):
        from ccvpe_torch.io.checkpoint import CheckpointManager
        from ccvpe_torch.train import harness

        probe = self

        def train_step(make):
            def made(*a, **kw):
                step = make(*a, **kw)

                def wrapped(state, batch, generator=None):
                    parts = step(state, batch, generator)
                    probe.losses.append(parts["loss"].detach())
                    return parts
                return wrapped
            return made

        def readout_step(make):
            def made(*a, **kw):
                step = make(*a, **kw)

                def wrapped(*args):
                    r = step(*args)
                    probe.readouts.append(dict(r))
                    return r
                return wrapped
            return made

        def train_epoch(orig):
            def wrapped(self, loader, fn, epoch):
                probe.trainers.append(self)
                pps = orig(self, loader, fn, epoch)
                probe.epochs.append({"epoch": epoch, "pairs_per_s": pps})
                return pps
            return wrapped

        def evaluate(orig):
            def wrapped(self, *a, **kw):
                from torch.profiler import ProfilerActivity, profile

                prof = (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
                        if probe.profile_eval else None)
                t0 = time.perf_counter()
                if prof is not None:
                    prof.__enter__()
                summary = orig(self, *a, **kw)
                torch.cuda.synchronize()
                rec = {"wall_ms": (time.perf_counter() - t0) * 1e3,
                       "pairs_per_sec": summary["pairs_per_sec"]}
                if prof is not None:
                    prof.__exit__(None, None, None)
                    rec["busy_ms"], rec["span_ms"] = _busy_ms(prof.events())
                probe.evals.append(rec)
                return summary
            return wrapped

        def timed(records):
            def wrap(orig):
                def wrapped(*a, **kw):
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    out = orig(*a, **kw)
                    torch.cuda.synchronize()
                    records.append((time.perf_counter() - t0) * 1e3)
                    return out
                return wrapped
            return wrap

        def resume(orig):
            def wrapped(self):
                ok = orig(self)
                if ok:
                    probe.resumes.append(_restored_equals_file(self))
                return ok
            return wrapped

        self._patch(TLOOP, "make_train_step", train_step)
        self._patch(TLOOP, "make_eval_readout_step", readout_step)
        self._patch(harness.Trainer, "train_epoch", train_epoch)
        self._patch(harness.Trainer, "evaluate", evaluate)
        self._patch(harness.Trainer, "resume", resume)
        self._patch(CheckpointManager, "save", timed(self.saves_ms))
        self._patch(CheckpointManager, "restore", timed(self.restores_ms))
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        return False

    def clear(self):
        for records in (self.trainers, self.epochs, self.losses, self.readouts, self.evals):
            del records[:]


def _restored_equals_file(trainer) -> dict:
    """The trainer's live state, just restored, against the checkpoint file
    it came from: every model tensor and Adam tensor bit for bit, the step,
    and the 4-d parameters still channels_last."""
    ckpt = trainer.ckpt
    saved = torch.load(ckpt.path(ckpt.latest_step()), map_location="cpu", weights_only=True)
    state = trainer.state
    n = 0
    for k, v in state.model.state_dict().items():
        if not torch.equal(v.cpu(), saved["model"][k]):
            raise AssertionError(f"resume: {k} differs from the checkpoint")
        n += 1
    live_opt = state.optimizer.state_dict()
    live = live_opt["state"]
    if live.keys() != saved["optimizer"]["state"].keys() or not live:
        raise AssertionError("resume: Adam's state is not the checkpoint's")
    for i, s in live.items():
        for k, v in s.items():
            if not torch.equal(v.cpu(), saved["optimizer"]["state"][i][k]):
                raise AssertionError(f"resume: Adam {k} of parameter {i} differs")
            n += 1
    # bf16 parameters: the float32 master, in parameter order
    masters = list(zip(live_opt.get("master", []), saved["optimizer"].get("master", []),
                       strict=True))
    for i, (a, b) in enumerate(masters):
        if a.dtype != torch.float32 or not torch.equal(a.cpu(), b):
            raise AssertionError(f"resume: the master of parameter {i} differs")
        n += 1
    if state.step != saved["step"]:
        raise AssertionError(f"resume: step {state.step} vs {saved['step']}")
    if not all(p.is_contiguous(memory_format=torch.channels_last)
               for p in state.model.parameters() if p.dim() == 4):
        raise AssertionError("resume: parameters left channels_last")
    return {"step": state.step, "tensors_equal": n, "masters_equal": len(masters),
            "param_dtypes": sorted({str(p.dtype)[6:] for p in state.model.parameters()})}


# the VIGOR eval settings of the ``cli`` phase and the kernel launches
# (K1, K2) of one forward in each: the CLI takes loc_offsets
# range(-n, n + 1) for ori_noise 18n (21 offsets at 180), so every setting
# adds the full-bin stack at the bottleneck (K2); at FoV 180 every scale
# takes K2's masked window
CLI_VIGOR_EVAL = {"ori_noise_180": (["--ori_noise", "180"], (6, 1)),
                  "ori_noise_36": (["--ori_noise", "36"], (6, 1)),
                  "fov_180": (["-f", "180", "--ori_noise", "0"], (0, 7))}
CLI_EVAL_BATCHES = 4
CLI_PROB_TOL = 1e-6


def _launches() -> dict:
    counts = MC.launch_counts()
    return {"K1": counts["matching_epilogue"], "K2": counts["matching_scores"],
            "by_layout": {f"{k} {lay}": n for (k, lay), n in MC.launch_counts("layout").items() if n},
            "by_dtype": _dtype_launches(), "bf16_by_layout": _bf16_layout_launches()}


def write_b0(path: str, seed: int = 0) -> str:
    """A raw EfficientNet-B0 state_dict in the release file's keys, from the
    port's seeded encoder (``--pretrained_b0`` reads it)."""
    from ccvpe_torch.nn.efficientnet import EfficientNet
    from ccvpe_torch.nn.layers import init_uniform_

    net = init_uniform_(EfficientNet("b0"), torch.Generator().manual_seed(seed))
    torch.save(net.state_dict(), path)
    return path


def _options_cli(tmp: str, roots: dict, common: list, probe) -> dict:
    """The training options through the CLIs: ``train_VIGOR --bf16
    --bf16_params --remat --pretrained_b0`` two steps, a checkpoint and a
    resumed epoch checked bit for bit; ``api.load_model`` of that
    checkpoint directory through the kernels against the plain versions;
    ``train_KITTI --device_augment --bf16`` and ``train_OxfordRobotCar
    --bf16`` two steps each (their validation runs in float32)."""
    from ccvpe_torch import train_KITTI, train_OxfordRobotCar, train_VIGOR

    b0 = write_b0(f"{tmp}/b0.pth")
    ck = f"{tmp}/options_ckpt"
    argv = common + ["--dataset_root", roots["vigor"], "--steps_per_epoch", "2",
                     "--checkpoint_dir", ck, "--results_dir", f"{tmp}/options_res",
                     "--keep_checkpoints", "1", "--bf16", "--bf16_params", "--remat",
                     "--pretrained_b0", b0]
    out = {}
    before = len(probe.resumes)
    out["vigor_first"] = _train_cli("VIGOR options train", train_VIGOR.main,
                                    argv + ["--epochs", "1"], probe, 2)
    out["vigor_resumed"] = _train_cli("VIGOR options resume", train_VIGOR.main,
                                      argv + ["--epochs", "2", "--resume"], probe, 2)
    if len(probe.resumes) != before + 1:
        raise AssertionError("the options run did not resume")
    out["resume_check"] = probe.resumes[-1]
    if out["resume_check"]["param_dtypes"] != ["bfloat16"] or not out["resume_check"][
            "masters_equal"]:
        raise AssertionError(f"options resume: {out['resume_check']}")
    # bf16 launches: the train steps' forwards only (validation runs in float32)
    for run in ("vigor_first", "vigor_resumed"):
        want = _bf16_launches(cvm.VIGOR, steps=2)
        if out[run]["launches"]["bf16_by_layout"] != want:
            raise AssertionError(f"{run}: bf16 launches {out[run]['launches']}, want {want}")
    probe.clear()
    gc.collect()
    torch.cuda.empty_cache()

    # the bf16-parameter checkpoint served through load_model
    model = api.load_model(ck, preset="VIGOR")
    plain = api.CVMModel(model.cfg, model.net, model.device, matching_impl="plain")
    grd, sat = _images(model.cfg, BATCH, seed=9)
    served = {}
    n_k1 = sum(cg == cs for _, cs, cg, _ in preset_scales(model.cfg))
    for kw, want in ((dict(ori_noise=180.0), (n_k1, 6 - n_k1)),
                     (dict(ori_noise=36.0), (n_k1, 7 - n_k1))):
        MC.reset_launch_counts()
        poses = model.predict_batch(grd, sat, **kw)
        got = tuple(MC.launch_counts().values())
        if got != want:
            raise AssertionError(f"load_model {kw}: launches {got}, want {want}")
        heading = 0.0
        for p, q in zip(poses, plain.predict_batch(grd, sat, **kw)):
            if (p.row, p.col) != (q.row, q.col) or not np.isfinite(p.orientation_deg):
                raise AssertionError(f"load_model {kw}: {p} vs {q}")
            heading = max(heading, abs((p.orientation_deg - q.orientation_deg + 180) % 360
                                       - 180))
        if heading > HEADING_TOL_DEG:
            raise AssertionError(f"load_model {kw}: heading differs by {heading} deg")
        served[json.dumps(kw)] = {"launches": got, "heading_err_deg": heading,
                                  "rows": [p.row for p in poses]}
    out["load_model"] = served
    del model, plain
    gc.collect()
    torch.cuda.empty_cache()

    # KITTI and Oxford in bf16: K2 (and KITTI's K1 at 256^2 x 32) inside a model
    for preset, main, root_flags in (
            ("KITTI", train_KITTI.main, ["--dataset_root", roots["kitti"], "--device_augment"]),
            ("OxfordRobotCar", train_OxfordRobotCar.main, ["--grd_image_root", roots["oxford"]])):
        run = _train_cli(f"{preset} bf16 train", main, common + root_flags + [
            "--epochs", "1", "--steps_per_epoch", "2", "--bf16", "--keep_checkpoints", "1",
            "--checkpoint_dir", f"{tmp}/{preset}_bf16_ckpt",
            "--results_dir", f"{tmp}/{preset}_bf16_res"], probe, 2)
        want = _bf16_launches(cvm.PRESETS[preset], steps=2)
        if run["launches"]["bf16_by_layout"] != want:
            raise AssertionError(f"{preset} bf16: launches {run['launches']}, want {want}")
        out[preset] = run
        probe.clear()
        gc.collect()
        torch.cuda.empty_cache()
    return out


def _readouts(probe) -> dict:
    return {k: torch.cat([r[k] for r in probe.readouts]).cpu()
            for k in ("pred_row", "pred_col", "prob_at_gt", "cos_pred", "sin_pred")}


def _kernel_vs_plain(tag, runs: dict) -> dict:
    """The ``kernel`` and ``plain`` eval runs of one setting: the same
    predicted row and col for every sample, equal distance metrics,
    prob_at_gt within CLI_PROB_TOL, heading within HEADING_TOL_DEG."""
    from ccvpe_torch.train.metrics import angle_from_cos_sin

    k, p = runs["kernel"]["readout"], runs["plain"]["readout"]
    if k["pred_row"].numel() == 0 or not (torch.equal(k["pred_row"], p["pred_row"])
                                          and torch.equal(k["pred_col"], p["pred_col"])):
        raise AssertionError(f"{tag}: kernel and plain predict other pixels")
    for split, sk in runs["kernel"]["summary"].items():
        sp = runs["plain"]["summary"][split]
        for key in ("mean_distance_m", "median_distance_m"):
            if sk[key] != sp[key] or not math.isfinite(sk[key]):
                raise AssertionError(f"{tag} {split}: {key} {sk[key]} vs {sp[key]}")
    prob = (k["prob_at_gt"] - p["prob_at_gt"]).abs().max().item()
    ak, vk = angle_from_cos_sin(k["cos_pred"].numpy(), k["sin_pred"].numpy())
    ap, _ = angle_from_cos_sin(p["cos_pred"].numpy(), p["sin_pred"].numpy())
    diff = np.abs((ak - ap + 180) % 360 - 180)[vk]
    heading = float(diff.max()) if diff.size else 0.0
    if not (prob <= CLI_PROB_TOL and heading <= HEADING_TOL_DEG):
        raise AssertionError(f"{tag}: prob_at_gt {prob}, heading {heading} deg")
    return {"samples": int(k["pred_row"].numel()), "prob_at_gt_max_abs_err": prob,
            "heading_err_deg": heading}


def _eval_both(tag, main, argv, probe, eval_keys) -> dict:
    """One eval CLI run through the kernels, then one through the plain
    versions, held to each other; launches of each."""
    runs = {}
    for impl in ("kernel", "plain"):
        probe.clear()
        MC.reset_launch_counts()
        out = main(argv + ["--matching_impl", impl])
        summaries = {k: out[k] for k in eval_keys} if eval_keys else {"all": out}
        runs[impl] = {"summary": summaries, "launches": _launches(),
                      "readout": _readouts(probe),
                      "pairs_per_s": [e["pairs_per_sec"] for e in probe.evals],
                      "wall_ms": [e["wall_ms"] for e in probe.evals]}
    if runs["plain"]["launches"]["K1"] or runs["plain"]["launches"]["K2"]:
        raise AssertionError(f"{tag}: the plain run launched {runs['plain']['launches']}")
    res = {"check": _kernel_vs_plain(tag, runs), "launches": runs["kernel"]["launches"],
           "eval_pairs_per_s": runs["kernel"]["pairs_per_s"],
           "eval_wall_ms": runs["kernel"]["wall_ms"],
           "plain_eval_pairs_per_s": runs["plain"]["pairs_per_s"],
           "median_distance_m": {s: v["median_distance_m"]
                                 for s, v in runs["kernel"]["summary"].items()}}
    return res


def _train_cli(tag, main, argv, probe, want_steps: int) -> dict:
    """One train CLI run: finite losses, the steps taken, each epoch's
    train pairs/s, the launches and the peak memory allocated."""
    probe.clear()
    MC.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    main(argv)
    losses = torch.stack(probe.losses).tolist()
    if len(losses) != want_steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: losses {losses}, want {want_steps} finite")
    return {"losses": losses, "epochs": list(probe.epochs), "launches": _launches(),
            "val_pairs_per_s": [e["pairs_per_sec"] for e in probe.evals],
            "peak_memory_gib": torch.cuda.max_memory_allocated() / 2 ** 30}


def _save_trained(probe, path: str) -> None:
    """The last trainer's model as a reference-format .pt, then free it."""
    trainer = probe.trainers[-1]
    api.CVMModel(trainer.model_cfg, trainer.state.model, trainer.device).save_torch(path)
    probe.clear()
    del trainer
    gc.collect()
    torch.cuda.empty_cache()


def phase_cli(dev: dict, roots: dict) -> dict:
    """The port's train and eval CLIs (``ccvpe_torch.train_VIGOR``,
    ``train_KITTI``, ``train_OxfordRobotCar``) through ``main([...])`` on the
    roots of ``write_roots``, full width, batch 8, float32, TF32 off:
    VIGOR trains an epoch of 3 steps, checkpoints, resumes bit for bit for a
    second, and its model evaluates in three settings; KITTI (with
    ``--device_augment``) and Oxford train 2 steps and evaluate; every eval
    runs through the kernels and through the plain versions, held to each
    other per sample."""
    from ccvpe_torch import train_KITTI, train_OxfordRobotCar, train_VIGOR
    from ccvpe_torch.io.checkpoint import CheckpointManager

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    info = {"phase": "cli", "card": dev["nvidia_smi"], "batch": BATCH, "dtype": "float32",
            "prob_tolerance": CLI_PROB_TOL, "heading_tolerance_deg": HEADING_TOL_DEG}
    t_phase = time.perf_counter()
    common = ["-b", str(BATCH), "--num_workers", "8"]
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_cli_") as tmp, _CliProbe() as probe:
        # 1. VIGOR: one epoch, a checkpoint, then a resumed second epoch
        res, ck = f"{tmp}/vigor_res", f"{tmp}/vigor_ckpt"
        argv = common + ["--dataset_root", roots["vigor"], "--steps_per_epoch", "3",
                         "--checkpoint_dir", ck, "--results_dir", res, "--keep_checkpoints", "1"]
        first = _train_cli("VIGOR train", train_VIGOR.main, argv + ["--epochs", "1"], probe, 3)
        manager = CheckpointManager(ck)
        meta = manager.meta(3)
        if manager.all_steps() != [3] or meta != {"step": 3, "epoch": 0, "completed": True}:
            raise AssertionError(f"VIGOR checkpoint: steps {manager.all_steps()}, meta {meta}")
        ckpt_bytes = os.path.getsize(manager.path(3))
        resumed = _train_cli("VIGOR resume", train_VIGOR.main,
                             argv + ["--epochs", "2", "--resume"], probe, 3)
        if [e["epoch"] for e in resumed["epochs"]] != [1] or len(probe.resumes) != 1:
            raise AssertionError(f"resume ran epochs {resumed['epochs']}")
        label = "samearea_HFoV360"
        for stem in ("mean_distance_error", "median_distance_error", "mean_orientation_error",
                     "median_orientation_error"):
            lines = Path(f"{res}/{label}_{stem}.txt").read_text().splitlines()
            if lines[0::2] != [f"{e}_{label}_{stem}:" for e in (0, 1)] or not all(
                    math.isfinite(float(v)) for v in lines[1::2]):
                raise AssertionError(f"results file {stem}: {lines}")
        summary_lines = Path(f"{res}/{label}_summary.json").read_text().splitlines()
        if [json.loads(x)["epoch"] for x in summary_lines] != [0, 1]:
            raise AssertionError(f"summary.json: {summary_lines}")
        info["vigor_train"] = {
            "first": first, "resumed": resumed, "resume_check": probe.resumes[0],
            "checkpoint_bytes": ckpt_bytes, "save_ms": list(probe.saves_ms),
            "restore_ms": list(probe.restores_ms), "results_lines": summary_lines}
        pt = f"{tmp}/vigor.pt"
        _save_trained(probe, pt)

        # 2. VIGOR eval of that model, kernel against plain in each setting
        info["vigor_eval"] = {}
        for name, (flags, (k1, k2)) in CLI_VIGOR_EVAL.items():
            argv = common + ["--dataset_root", roots["vigor"], "--training", "False",
                             "--steps_per_epoch", str(CLI_EVAL_BATCHES), "--test_model_path", pt,
                             "--results_dir", f"{tmp}/eval_res", *flags]
            r = _eval_both(f"VIGOR eval {name}", train_VIGOR.main, argv, probe, None)
            want = {"K1": k1 * CLI_EVAL_BATCHES, "K2": k2 * CLI_EVAL_BATCHES}
            if {k: r["launches"][k] for k in want} != want:
                raise AssertionError(f"VIGOR eval {name}: launches {r['launches']}, want {want}")
            info["vigor_eval"][name] = r
        # the card's idle share over one eval pass: busy device ms under the
        # profiler over the same setting's unprofiled wall time
        probe.clear()
        probe.profile_eval = True
        train_VIGOR.main(common + ["--dataset_root", roots["vigor"], "--training", "False",
                                   "--steps_per_epoch", str(CLI_EVAL_BATCHES),
                                   "--test_model_path", pt, "--matching_impl", "kernel",
                                   "--results_dir", f"{tmp}/eval_res"])
        probe.profile_eval = False
        prof = probe.evals[-1]
        wall_ms = info["vigor_eval"]["ori_noise_180"]["eval_wall_ms"][0]
        info["vigor_eval_idle"] = {"busy_ms": prof["busy_ms"], "profiled_wall_ms": prof["wall_ms"],
                                   "unprofiled_wall_ms": wall_ms,
                                   "idle_share": 1 - prof["busy_ms"] / wall_ms,
                                   "idle_share_profiled": 1 - prof["busy_ms"] / prof["wall_ms"]}
        probe.clear()

        # 3. KITTI and Oxford: two train steps, then kernel against plain eval
        for preset, main, root_flags, eval_keys in (
                ("KITTI", train_KITTI.main, ["--dataset_root", roots["kitti"]],
                 ("test1", "test2")),
                ("OxfordRobotCar", train_OxfordRobotCar.main,
                 ["--grd_image_root", roots["oxford"]], ("test1", "test2", "test3"))):
            extra = ["--device_augment"] if preset == "KITTI" else []
            trained = _train_cli(f"{preset} train", main, common + root_flags + [
                "--epochs", "1", "--steps_per_epoch", "2", "--keep_checkpoints", "1",
                "--checkpoint_dir", f"{tmp}/{preset}_ckpt", "--results_dir", f"{tmp}/{preset}_res",
                *extra], probe, 2)
            pt = f"{tmp}/{preset}.pt"
            _save_trained(probe, pt)
            evaluated = _eval_both(f"{preset} eval", main, common + root_flags + [
                "--training", "False", "--steps_per_epoch", "2", "--test_model_path", pt,
                "--results_dir", f"{tmp}/{preset}_eval"], probe, eval_keys)
            info[preset] = {"train": trained, "eval": evaluated}
            gc.collect()
            torch.cuda.empty_cache()

        # 4. the training options
        info["options"] = _options_cli(tmp, roots, common, probe)
    info["seconds"] = time.perf_counter() - t_phase
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


SERVE_KEYS = ((180.0, 360.0), (36.0, 360.0), (180.0, 180.0))
SERVE_CLIENTS, SERVE_PER_CLIENT = 16, 6
SERVE_PROB_TOL = 1e-6
SERVE_TIMEOUT_S = 2.0          # the server's request_timeout (the 408 case)
SERVE_MAX_BODY = 16 << 20      # the server's max_body_bytes (the 413 case)


def _png_b64(arr: np.ndarray) -> str:
    import base64
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", compress_level=1)
    return base64.b64encode(buf.getvalue()).decode()


def _client_load(url: str, bodies: list, clients: int) -> tuple[list, float]:
    """POST each body to ``url``/predict from ``clients`` threads: (status,
    answer, seconds) per request, and the wall seconds of the whole load."""
    import concurrent.futures
    import urllib.error
    import urllib.request

    def post(body):
        req = urllib.request.Request(url + "/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        t0 = time.perf_counter()
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read()), time.perf_counter() - t0
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read()), time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        t0 = time.perf_counter()
        out = list(pool.map(post, bodies))
        return out, time.perf_counter() - t0


def _raw_status(port: int, head: bytes, body: bytes = b"") -> int:
    """Send ``head`` and ``body`` on a fresh socket; the HTTP status the
    server answers with."""
    import socket

    with socket.create_connection(("127.0.0.1", port), timeout=30) as sock:
        sock.sendall(head + body)
        data = b""
        while b"\r\n" not in data:
            chunk = sock.recv(4096)
            if not chunk:
                break
            data += chunk
    return int(data.split(b" ", 2)[1])


def phase_serve(dev: dict, model: api.CVMModel) -> dict:
    """The HTTP pose service (``ccvpe_torch.serve``) on 127.0.0.1 with the
    seeded, BN-calibrated VIGOR model of phase ``model``, batch 8,
    ``max_wait_ms`` 5: 96 ``/predict`` requests from 16 client threads (in
    a process of their own) over three (ori_noise, fov) keys, PNGs at model
    size and a few at raw size;
    every answer against ``predict_batch`` through the plain versions; a
    413 and a 408; then the same load under ``torch.profiler`` for the
    card's idle share."""
    import concurrent.futures
    import multiprocessing
    import threading

    from ccvpe_torch import serve
    from ccvpe_torch.api import _prepare

    torch.backends.cudnn.allow_tf32 = False
    cfg = model.cfg
    rng = np.random.default_rng(40)
    pairs = []
    for i in range(24):
        raw = i % 8 == 7      # three pairs at a raw size: the service resizes them
        ghw, shw = ((512, 1024), (640, 640)) if raw else (cfg.grd_hw, cfg.sat_hw)
        grd = rng.integers(0, 256, (*ghw, 3), dtype=np.uint8)
        sat = rng.integers(0, 256, (*shw, 3), dtype=np.uint8)
        pairs.append((grd, sat, _png_b64(grd), _png_b64(sat)))
    n = SERVE_CLIENTS * SERVE_PER_CLIENT
    requests = [(pairs[i % len(pairs)], SERVE_KEYS[i % len(SERVE_KEYS)]) for i in range(n)]

    service = serve.PoseService(model, cfg.name, batch=BATCH, max_wait_ms=5.0)
    srv = serve.build_server(service, "127.0.0.1", 0, max_body_bytes=SERVE_MAX_BODY,
                             request_timeout=SERVE_TIMEOUT_S)
    port = srv.server_address[1]
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{port}"

    bodies = [json.dumps({"grd": g64, "sat": s64, "ori_noise": noise, "fov": fov}).encode()
              for (_, _, g64, s64), (noise, fov) in requests]
    # the clients run in a process of their own, as a deployment's would:
    # their JSON and sockets do not take the server's interpreter lock
    clients = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))

    def load():
        out, wall = clients.submit(_client_load, url, bodies, SERVE_CLIENTS).result()
        torch.cuda.synchronize()
        return out, wall

    def post(i):
        return _client_load(url, [bodies[i]], 1)[0][0]

    info = {"phase": "serve", "card": dev["nvidia_smi"], "preset": cfg.name, "batch": BATCH,
            "max_wait_ms": 5.0, "clients": SERVE_CLIENTS, "requests": n,
            "keys": [list(k) for k in SERVE_KEYS]}
    try:
        # warm every key's batcher (the first forward at a shape picks cuDNN's algorithms)
        for k in range(len(SERVE_KEYS)):
            post(k)
        before = {k: (b.dispatches, b.items_served) for k, b in service.batchers.items()}
        rejections0 = service.metrics()["rejections"]
        MC.reset_launch_counts()
        answers, wall = load()
        launches = MC.launch_counts()
        disp = {k: b.dispatches - before[k][0] for k, b in service.batchers.items()}
        served = {k: b.items_served - before[k][1] for k, b in service.batchers.items()}
        metrics = service.metrics()
        codes = [c for c, _, _ in answers]
        if codes.count(200) + codes.count(503) != n or not codes.count(200):
            raise AssertionError(f"serve: status codes {sorted(set(codes))}")
        # every answer against predict_batch through the plain versions
        plain = api.CVMModel(cfg, model.net, model.device, matching_impl="plain")
        worst_prob, worst_heading, checked = 0.0, 0.0, 0
        for key in SERVE_KEYS:
            idx = [i for i in range(n) if requests[i][1] == key and answers[i][0] == 200]
            for lo in range(0, len(idx), BATCH):
                chunk = idx[lo:lo + BATCH]
                grd = np.stack([_prepare(requests[i][0][0], cfg.grd_hw) for i in chunk])
                sat = np.stack([_prepare(requests[i][0][1], cfg.sat_hw) for i in chunk])
                ref = plain.predict_batch(grd, sat, ori_noise=key[0], fov=key[1])
                for i, q in zip(chunk, ref):
                    got = answers[i][1]
                    if (got["row"], got["col"]) != (q.row, q.col):
                        raise AssertionError(f"serve {key}: {got} vs plain {q}")
                    worst_prob = max(worst_prob, abs(got["probability"] - q.probability))
                    worst_heading = max(worst_heading, abs(
                        (got["orientation_deg"] - q.orientation_deg + 180) % 360 - 180))
                    checked += 1
        if not (worst_prob <= SERVE_PROB_TOL and worst_heading <= HEADING_TOL_DEG):
            raise AssertionError(f"serve: probability {worst_prob}, heading {worst_heading}")
        # the kernels each key's forward launches (VIGOR: K1 x6 at the full
        # panorama, K2 for the prior's full-bin stack, K2 x6 at fov=180)
        n_k1 = sum(cg == cs for _, cs, cg, _ in preset_scales(cfg))
        full = disp[SERVE_KEYS[0]] + disp[SERVE_KEYS[1]]
        k1 = n_k1 * full
        k2_prior, k2_fov = disp[SERVE_KEYS[1]], 6 * disp[SERVE_KEYS[2]]
        k2 = (6 - n_k1) * full + k2_prior + k2_fov
        if launches != {"matching_epilogue": k1, "matching_scores": k2}:
            raise AssertionError(f"serve launches {launches}, dispatches {disp}")

        # a 413 (from the header alone) and a 408 (a body that stalls)
        big = _raw_status(port, f"POST /predict HTTP/1.1\r\nHost: x\r\nContent-Length: "
                                f"{SERVE_MAX_BODY + 1}\r\n\r\n".encode())
        t0 = time.perf_counter()
        stalled = _raw_status(port, b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                                    b"Content-Length: 1000\r\n\r\n", b'{"grd": "')
        stall_s = time.perf_counter() - t0
        if (big, stalled) != (413, 408):
            raise AssertionError(f"serve: oversized body {big}, stalled body {stalled}")

        # the card's idle share under the same load: busy device ms over wall ms
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, prof_wall = load()
        busy_ms, span_ms = _busy_ms(prof.events())
        lat = sorted(t for c, _, t in answers if c == 200)
        info.update({
            "seconds": wall, "requests_per_s": codes.count(200) / wall,
            "client_latency_ms": {"p50": lat[len(lat) // 2] * 1e3,
                                  "p95": lat[min(len(lat) - 1, int(len(lat) * 0.95))] * 1e3,
                                  "max": lat[-1] * 1e3},
            "server_metrics": metrics, "status_503": codes.count(503),
            "rejections": metrics["rejections"] - rejections0,
            "dispatches": {json.dumps(list(k)): v for k, v in disp.items()},
            "mean_batch_fill": sum(served.values()) / max(1, sum(disp.values())) / BATCH,
            "launches": {**launches, "matching_scores_prior": k2_prior,
                         "matching_scores_fov": k2_fov},
            "checked_against_plain": checked, "prob_max_abs_err": worst_prob,
            "heading_err_deg": worst_heading, "prob_tolerance": SERVE_PROB_TOL,
            "status_oversized": big, "status_stalled": stalled, "stall_answer_s": stall_s,
            "profiled": {"wall_ms": prof_wall * 1e3, "busy_ms": busy_ms, "span_ms": span_ms,
                         "idle_share": 1 - busy_ms / (prof_wall * 1e3)}})
    finally:
        clients.shutdown()
        srv.shutdown()
        srv.server_close()
        service.stop()
    emit(info)
    return info


def quant_launches(cfg) -> dict:
    """The int8 model's main path: the serve phase's three keys, each with
    the (K1, K2) launches of one forward (VIGOR: K1 at the six scales; the
    prior adds the full-bin bottleneck stack, K2; fov=180 halves Cg, so K2's
    masked window takes all six)."""
    n_k1 = sum(cg == cs for _, cs, cg, _ in preset_scales(cfg))
    return {(180.0, 360.0): (n_k1, 6 - n_k1), (36.0, 360.0): (n_k1, 7 - n_k1),
            (180.0, 180.0): (0, 6)}


QUANT_SERVE_CLIENTS, QUANT_SERVE_PER_CLIENT = 8, 6
# the int8 model through K1/K2 against the plain matching: the kernels' sums
# differ from the plain versions' in the last bits, which flips an
# activation code wherever a value sits on a rounding tie, and a flipped
# code moves the decoder's outputs by a quantization step.  The pixel, the
# heatmap and the heading keep the model phase's gates.  The logits,
# orientation field and stacks are held to half of the int8 model's own
# distance from the float32 model (never tighter than the model phase's):
# on the H100 the logits moved by 1.5e-3 at 103 of 2 097 152 pixels (over
# the model phase's 1e-3), 0.38 of that distance; this share was set after
# that reading.
QUANT_FLIP_SHARE = 0.5
INT8_RANGE = "int8_conv"      # the profiler range around each QuantConv2d call
MATCH_KERNELS = ("match_row_kernel", "match_warp_kernel", "match_tile_kernel",
                 "match_scores_tile_kernel")


def _int_mm_limits() -> dict:
    """What ``torch._int_mm`` takes on this card: operand shapes (rows M,
    depth K, columns N; B as the transpose of a row-major [N, K], as the int8
    conv passes it, or row-major [K, N]) and the first line of each refusal."""
    def probe(m, k, n, transposed=True):
        a = torch.ones((m, k), dtype=torch.int8, device="cuda")
        b = (torch.ones((n, k), dtype=torch.int8, device="cuda").t() if transposed
             else torch.ones((k, n), dtype=torch.int8, device="cuda"))
        try:
            y = torch._int_mm(a, b)
            torch.cuda.synchronize()
            return "ok" if int(y[0, 0]) == k else f"wrong sum {int(y[0, 0])}"
        except RuntimeError as e:
            return str(e).strip().splitlines()[0][:160]

    out = {f"M{m} K{k} N{n}": probe(m, k, n)
           for m, k, n in ((17, 32, 8), (16, 32, 8), (32, 27, 8), (32, 32, 1), (32, 32, 2))}
    out["M32 K32 N8, B row-major [K, N]"] = probe(32, 32, 8, transposed=False)
    return out


def _int8_conv_checks(qmodel: api.CVMModel, grd, sat) -> dict:
    """Every int8 conv shape of the model on the card, at the inputs of one
    forward (batch 8, ori_noise 180): the int32 sums of ``int8_conv_mm``
    (``torch._int_mm`` over the int8 im2col) against the plain version (the
    same codes through a float64 conv), exactly."""
    seen, rows = set(), []

    def check(m, args):
        circular = args[1] if len(args) > 1 and args[1] is not None else m.circular
        xq = TL.pad_nhwc(TL.quantize_activation(args[0].permute(0, 2, 3, 1), m.inv_sx),
                         m.static_pad, circular)
        key = (tuple(xq.shape), tuple(m.weight.shape), m.stride)
        if key in seen:
            return
        seen.add(key)
        got = TL.int8_conv_mm(xq, m.w_mat, m.kernel, m.stride, m.weight.shape[0])
        want = TL.int8_conv_plain(xq, m.weight, m.stride)
        if got.dtype != torch.int32 or not torch.equal(got, want):
            raise AssertionError(f"int8 conv {key}: torch._int_mm sums differ from the plain "
                                 f"version's by {(got.double() - want.double()).abs().max()}")
        b, ho, wo, _ = got.shape
        n_pad, k_pad = m.w_mat.shape
        direct = m.kernel == m.stride == 1 and k_pad == xq.shape[-1] and b * ho * wo >= 17
        rows.append({"x": list(xq.shape), "w": list(m.weight.shape), "stride": m.stride,
                     "M": b * ho * wo, "K": k_pad, "N": n_pad,
                     "im2col_bytes": 0 if direct else max(b * ho * wo, 32) * k_pad,
                     "max_abs_sum": int(got.abs().max())})

    mods = [m for m in qmodel.net.modules() if isinstance(m, TL.QuantConv2d)]
    handles = [m.register_forward_pre_hook(check) for m in mods]
    try:
        qmodel.forward_readout(grd, sat)
        torch.cuda.synchronize()
    finally:
        for h in handles:
            h.remove()
    biggest = max(rows, key=lambda r: r["im2col_bytes"])
    return {"shapes": len(rows), "int8_convs": len(mods), "equal": True,
            "largest_im2col": biggest, "max_abs_sum": max(r["max_abs_sum"] for r in rows),
            "rows": rows}


def _pairs_per_s(model: api.CVMModel, grd, sat, n: int = 10) -> float:
    for _ in range(3):
        model.predict_batch(grd, sat)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        model.predict_batch(grd, sat)
    return BATCH * n / (time.perf_counter() - t0)


def _quant_profile(qmodel: api.CVMModel, grd, sat, out: Path | None) -> dict:
    """Device ms of one ``predict_batch`` by part, over three profiled
    calls: the int8 products (``aten::_int_mm``), the int8 conv's other
    passes (quantize, pad, im2col, dequantize, bias: the rest of the
    ``INT8_RANGE`` around each ``QuantConv2d`` call, a range this profile
    alone puts there), K1 and K2, and everything else.  ``out`` None: the
    float32 model (no int8 parts), no table written."""
    from torch.profiler import ProfilerActivity, profile, record_function

    forward = TL.QuantConv2d.forward

    def ranged(self, x, circular=None):
        with record_function(INT8_RANGE):
            return forward(self, x, circular)

    TL.QuantConv2d.forward = ranged
    try:
        qmodel.predict_batch(grd, sat)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(3):
                qmodel.predict_batch(grd, sat)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) / 3 * 1e3
    finally:
        TL.QuantConv2d.forward = forward
    events = prof.events()

    def inside(e):
        while e is not None:
            if e.name == INT8_RANGE:
                return True
            e = e.cpu_parent
        return False

    parts = {"int8_products": 0.0, "int8_passes": 0.0, "rest": 0.0}
    for e in events:
        if e.device_type != torch.autograd.DeviceType.CPU:
            continue
        for k in e.kernels:
            if any(n in k.name for n in MATCH_KERNELS):
                continue
            part = ("int8_products" if e.name == "aten::_int_mm"
                    else "int8_passes" if inside(e) else "rest")
            parts[part] += k.duration / 3e3
    parts["matching_K1_K2"] = sum(
        (e.time_range.end - e.time_range.start) / 3e3 for e in events
        if e.device_type == torch.autograd.DeviceType.CUDA
        and any(n in e.name for n in MATCH_KERNELS))
    busy_ms, _ = _busy_ms(events)
    if out is not None:
        (out / "quant_profile.txt").write_text(
            prof.key_averages().table(sort_by="device_time_total", row_limit=60))
    int8 = any(isinstance(m, TL.QuantConv2d) for m in qmodel.net.modules())
    if not ((parts["int8_products"] > 0) == int8 and parts["matching_K1_K2"] > 0):
        raise AssertionError(f"the int8 profile shows no int8 products or no K1/K2: {parts}")
    return {"device_ms_per_call": {**parts, "total": sum(parts.values())},
            "busy_ms_per_call": busy_ms / 3, "wall_ms_per_call_profiled": wall_ms}


def _serve_int8(model: api.CVMModel, tmp: str) -> dict:
    """``python -m ccvpe_torch.serve --quantize int8 --calib_dir D`` through
    ``serve.main`` on 127.0.0.1, on the ``model`` phase's weights (written
    as a ``.pt``) at batch 8: 48 requests from 8 client threads (in a
    process of their own) over the three keys; every answer against the
    served int8 model's own ``predict_batch``; requests/s; launches."""
    import concurrent.futures
    import multiprocessing
    import threading

    from PIL import Image

    from ccvpe_torch import serve
    from ccvpe_torch.api import _prepare

    cfg = model.cfg
    pt = f"{tmp}/vigor.pt"
    model.save_torch(pt)
    rng = np.random.default_rng(61)
    calib_dir = Path(tmp) / "calib"
    for d in ("grd", "sat"):
        (calib_dir / d).mkdir(parents=True)
    for i in range(4):
        Image.fromarray(rng.integers(0, 256, (*cfg.grd_hw, 3), dtype=np.uint8)).save(
            calib_dir / "grd" / f"{i}.png")
        Image.fromarray(rng.integers(0, 256, (*cfg.sat_hw, 3), dtype=np.uint8)).save(
            calib_dir / "sat" / f"{i}.png")
    pairs = []
    for _ in range(12):
        grd = rng.integers(0, 256, (*cfg.grd_hw, 3), dtype=np.uint8)
        sat = rng.integers(0, 256, (*cfg.sat_hw, 3), dtype=np.uint8)
        pairs.append((grd, sat, _png_b64(grd), _png_b64(sat)))
    n = QUANT_SERVE_CLIENTS * QUANT_SERVE_PER_CLIENT
    want = quant_launches(cfg)
    keys = list(want)
    requests = [(pairs[i % len(pairs)], keys[i % len(keys)]) for i in range(n)]
    bodies = [json.dumps({"grd": g64, "sat": s64, "ori_noise": noise, "fov": fov}).encode()
              for (_, _, g64, s64), (noise, fov) in requests]

    started, ready, failed = {}, threading.Event(), []
    build = serve.build_server

    def build_local(service, host, port, **kw):
        srv = build(service, "127.0.0.1", 0, **kw)
        started.update(service=service, srv=srv)
        ready.set()
        return srv

    def run():
        try:
            serve.main(["--checkpoint", pt, "--preset", cfg.name, "--batch", str(BATCH),
                        "--max_wait_ms", "5", "--quantize", "int8", "--calib_dir",
                        str(calib_dir), "--calib_samples", "4"])
        except BaseException as e:  # noqa: BLE001 — reported to the phase
            failed.append(e)
            ready.set()

    serve.build_server = build_local
    thread = threading.Thread(target=run, daemon=True)
    t0 = time.perf_counter()
    thread.start()
    clients = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        if not ready.wait(timeout=300) or failed:
            raise AssertionError(f"serve --quantize int8 did not start: {failed}")
        startup_s = time.perf_counter() - t0
        service, srv = started["service"], started["srv"]
        qmodel = service.model
        n_int8 = sum(isinstance(m, TL.QuantConv2d) for m in qmodel.net.modules())
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        for k in range(len(keys)):      # warm every key's batcher
            clients.submit(_client_load, url, [bodies[k]], 1).result()
        before = {k: b.dispatches for k, b in service.batchers.items()}
        MC.reset_launch_counts()
        TL.reset_int8_counts()
        answers, wall = clients.submit(_client_load, url, bodies, QUANT_SERVE_CLIENTS).result()
        torch.cuda.synchronize()
        launches, int8 = MC.launch_counts(), TL.int8_counts()
        disp = {k: b.dispatches - before[k] for k, b in service.batchers.items()}
        codes = [c for c, _, _ in answers]
        if codes.count(200) != n:
            raise AssertionError(f"serve int8: status codes {sorted(set(codes))}")
        k1 = sum(want[k][0] * d for k, d in disp.items())
        k2 = sum(want[k][1] * d for k, d in disp.items())
        if launches != {"matching_epilogue": k1, "matching_scores": k2}:
            raise AssertionError(f"serve int8 launches {launches}, dispatches {disp}")
        if int8 != {"mm": n_int8 * sum(disp.values()), "plain": 0}:
            raise AssertionError(f"serve int8: int8 products {int8}, dispatches {disp}")
        worst_prob, worst_heading = 0.0, 0.0
        for key in keys:
            idx = [i for i in range(n) if requests[i][1] == key]
            for lo in range(0, len(idx), BATCH):
                chunk = idx[lo:lo + BATCH]
                grd = np.stack([_prepare(requests[i][0][0], cfg.grd_hw) for i in chunk])
                sat = np.stack([_prepare(requests[i][0][1], cfg.sat_hw) for i in chunk])
                with service.lock:
                    ref = qmodel.predict_batch(grd, sat, ori_noise=key[0], fov=key[1])
                for i, q in zip(chunk, ref):
                    got = answers[i][1]
                    if (got["row"], got["col"]) != (q.row, q.col):
                        raise AssertionError(f"serve int8 {key}: {got} vs direct {q}")
                    worst_prob = max(worst_prob, abs(got["probability"] - q.probability))
                    worst_heading = max(worst_heading, abs(
                        (got["orientation_deg"] - q.orientation_deg + 180) % 360 - 180))
        if not (worst_prob <= SERVE_PROB_TOL and worst_heading <= HEADING_TOL_DEG):
            raise AssertionError(f"serve int8: probability {worst_prob}, heading {worst_heading}")
        lat = sorted(t for _, _, t in answers)
        return {"requests": n, "clients": QUANT_SERVE_CLIENTS, "startup_seconds": startup_s,
                "seconds": wall, "requests_per_s": n / wall,
                "client_latency_ms": {"p50": lat[len(lat) // 2] * 1e3, "max": lat[-1] * 1e3},
                "dispatches": {json.dumps(list(k)): v for k, v in disp.items()},
                "launches": {**launches,
                             "matching_scores_prior": (want[keys[1]][1] - want[keys[0]][1])
                             * disp[keys[1]],
                             "matching_scores_fov": want[keys[2]][1] * disp[keys[2]]},
                "int8_products": int8, "prob_max_abs_err": worst_prob,
                "heading_err_deg": worst_heading}
    finally:
        clients.shutdown()
        serve.build_server = build
        if "srv" in started:
            started["srv"].shutdown()
            started["srv"].server_close()
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("serve --quantize int8 did not stop")


def phase_quant(dev: dict, model: api.CVMModel, out: Path | None) -> dict:
    """int8 post-training quantization of the ``model`` phase's VIGOR model
    (a copy; batch 8, TF32 off unless said): ``quantize_int8`` on a seeded
    batch (seconds); ``torch._int_mm``'s limits on this card; every int8
    conv shape's sums against the plain version, exactly; ``predict_batch``
    at the keys (180, 360), (36, 360) and (180, 180) through K1/K2 against
    the plain matching (the same pixel for every sample, the ``model``
    phase's tolerances; K1/K2 launches and int8 products counted from 0);
    the int8 readout's distance from the float32 model's (not gated);
    int8 against float32 pairs/s (TF32 off and on), peak GiB, device ms by
    part; ``serve --quantize int8``'s requests/s and answers."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_phase = time.perf_counter()
    cfg = model.cfg
    qmodel = api.CVMModel(cfg, copy.deepcopy(model.net), model.device)
    calib = [_images(cfg, 2, seed=50)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    qmodel.quantize_int8(calib)
    torch.cuda.synchronize()
    calib_s = time.perf_counter() - t0
    mods = [m for m in qmodel.net.modules() if isinstance(m, TL.QuantConv2d)]
    if any(m.weight.device != next(model.net.parameters()).device for m in mods):
        raise AssertionError("quantize_int8 left int8 convs off the model's device")
    info = {"phase": "quant", "card": dev["nvidia_smi"], "preset": cfg.name, "batch": BATCH,
            "calibration_pairs": 2, "calibration_seconds": calib_s, "int8_convs": len(mods),
            "quantized_fraction": TQ.quantized_fraction(qmodel.net),
            "int_mm_limits": _int_mm_limits()}
    grd, sat = _images(cfg, BATCH, seed=60)
    checks = _int8_conv_checks(qmodel, grd, sat)
    info["int8_conv_checks"] = {k: v for k, v in checks.items() if k != "rows"}

    # the main path, one key at a time, every count at 0 just before it
    plain = api.CVMModel(cfg, qmodel.net, model.device, matching_impl="plain")
    results, launches = [], {}
    want_launches = quant_launches(cfg)
    for key, want in want_launches.items():
        kw = dict(ori_noise=key[0], fov=key[1])
        MC.reset_launch_counts()
        TL.reset_int8_counts()
        poses = qmodel.predict_batch(grd, sat, return_heatmap=True, **kw)
        counts, int8 = MC.launch_counts(), TL.int8_counts()
        launches[key] = (counts["matching_epilogue"], counts["matching_scores"])
        if launches[key] != want or int8 != {"mm": len(mods), "plain": 0}:
            raise AssertionError(f"int8 VIGOR {kw}: (K1, K2) launches {launches[key]} (want "
                                 f"{want}), int8 products {int8} (want {len(mods)} on the card)")
        o, r = qmodel.forward_readout(grd, sat, return_heatmap=True, **kw)
        ref, rr = plain.forward_readout(grd, sat, return_heatmap=True, **kw)
        f32, _ = model.forward_readout(grd, sat, return_heatmap=True, **kw)
        own = {"logits": _max_err(o.logits_flattened, f32.logits_flattened),
               "ori": _max_err(o.ori, f32.ori),
               "stacks": max(_max_err(a, b) for a, b in zip(o.matching_scores,
                                                            f32.matching_scores))}
        tol = {"heatmap": MODEL_TOL["heatmap"],
               **{k: max(MODEL_TOL[k], QUANT_FLIP_SHARE * v) for k, v in own.items()}}
        errs = _compare(f"int8 VIGOR {kw}", o, ref, r, rr, tol)
        ref_poses = plain.predict_batch(grd, sat, return_heatmap=True, **kw)
        f32_poses = model.predict_batch(grd, sat, **kw)
        heading, hm = 0.0, 0.0
        for p, q in zip(poses, ref_poses):
            if (p.row, p.col) != (q.row, q.col) or not 0 <= p.probability <= 1:
                raise AssertionError(f"int8 VIGOR {kw}: pose {p} vs plain {q}")
            heading = max(heading, abs((p.orientation_deg - q.orientation_deg + 180) % 360 - 180))
            hm = max(hm, float(np.abs(p.heatmap - q.heatmap).max()))
        if heading > HEADING_TOL_DEG or hm > MODEL_TOL["heatmap"]:
            raise AssertionError(f"int8 VIGOR {kw}: heading {heading} deg, heatmap {hm}")
        px = [math.hypot(p.row - f.row, p.col - f.col) for p, f in zip(poses, f32_poses)]
        deg = [abs((p.orientation_deg - f.orientation_deg + 180) % 360 - 180)
               for p, f in zip(poses, f32_poses)]
        results.append({"setting": kw, "launches": launches[key], "int8_products": int8,
                        "max_abs_err": errs, "tolerance": tol, "int8_vs_float32_max_abs": own,
                        "within_model_tolerance": {k: v <= MODEL_TOL[k] for k, v in errs.items()},
                        "logits_over_model_tolerance": int(
                            ((o.logits_flattened - ref.logits_flattened).abs()
                             > MODEL_TOL["logits"]).sum()),
                        "heading_err_deg": heading,
                        "vs_float32": {"pixels_mean": statistics.mean(px), "pixels_max": max(px),
                                       "same_pixel": sum(d == 0 for d in px),
                                       "heading_deg_mean": statistics.mean(deg),
                                       "heading_deg_max": max(deg)}})
    info.update(results=results, model_tolerance=MODEL_TOL, flip_share=QUANT_FLIP_SHARE,
                heading_tolerance_deg=HEADING_TOL_DEG,
                launches={"matching_epilogue": sum(k1 for k1, _ in launches.values()),
                          "matching_scores_prior": launches[(36.0, 360.0)][1]
                          - launches[(180.0, 360.0)][1],
                          "matching_scores_fov": launches[(180.0, 180.0)][1]})

    # int8 against float32 in turns (f32, int8, int8, f32), TF32 off and on
    timing = {}
    for label, tf32 in (("tf32_off", False), ("cudnn_tf32_default", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        f1, q1 = _pairs_per_s(model, grd, sat), _pairs_per_s(qmodel, grd, sat)
        q2, f2 = _pairs_per_s(qmodel, grd, sat), _pairs_per_s(model, grd, sat)
        timing[label] = {"float32_pairs_per_s": [f1, f2], "int8_pairs_per_s": [q1, q2],
                         "int8_over_float32": (q1 + q2) / (f1 + f2)}
    torch.backends.cudnn.allow_tf32 = False
    peak = {}
    for label, m in (("float32", model), ("int8", qmodel)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m.predict_batch(grd, sat)
        peak[label] = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "above_resident_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    info.update(timing=timing, peak=peak, profile={
        "int8": _quant_profile(qmodel, grd, sat, out),
        "float32": _quant_profile(model, grd, sat, None)})
    del qmodel, plain
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_quant_") as tmp:
        info["serve"] = _serve_int8(model, tmp)
    info["seconds"] = time.perf_counter() - t_phase
    emit(info)
    return info


def kernels_line(kern: dict, model: dict, presets: dict, train: dict, data: dict, cli: dict,
                 dev: dict, options: dict | None = None, serve: dict | None = None,
                 quant: dict | None = None) -> list[dict]:
    """The rows of the ``kernels`` line: each kernel's times at its shapes
    (phase ``kernels``, ``model_presets``) and its launches on each main
    path, each counted from 0 just before that path ran."""
    summary = kern["summary"]
    per = model["launches_per_setting"]   # (K1, K2) per setting
    by_path = {"predict_batch": model["launches"]["matching_epilogue"],
               "train_step": train["launches"]["matching_epilogue"],
               "train_step_fed": data["launches"]["matching_epilogue"]}
    # the CLIs: VIGOR's train runs (steps and validation) and eval settings,
    # KITTI's and Oxford's train and eval runs (kernel side)
    vigor_eval = cli["vigor_eval"]
    cli_k = {"cli_train_VIGOR": {k: cli["vigor_train"]["first"]["launches"][k]
                                 + cli["vigor_train"]["resumed"]["launches"][k]
                                 for k in ("K1", "K2")},
             "cli_eval_VIGOR_prior": {k: sum(vigor_eval[s]["launches"][k] for s in
                                             ("ori_noise_180", "ori_noise_36"))
                                      for k in ("K1", "K2")},
             "cli_eval_VIGOR_fov180": vigor_eval["fov_180"]["launches"]}
    for preset in ("KITTI", "OxfordRobotCar"):
        cli_k[f"cli_{preset}"] = {k: cli[preset]["train"]["launches"][k]
                                  + cli[preset]["eval"]["launches"][k] for k in ("K1", "K2")}
    by_path.update(cli_train_VIGOR=cli_k["cli_train_VIGOR"]["K1"],
                   cli_eval_VIGOR=cli_k["cli_eval_VIGOR_prior"]["K1"]
                   + cli_k["cli_eval_VIGOR_fov180"]["K1"])
    summary[0]["launches"] = sum(by_path.values())
    summary[0]["launches_by_path"] = by_path
    summary[0]["backward"] = "autograd through the plain version"
    summary[0]["backward_ms_per_train_step"] = train["profile"]["device_ms"]["matching_backward"]
    k2_prior = per[json.dumps(dict(ori_noise=36.0))][1]
    k2_fov = per[json.dumps(dict(fov=180.0))][1]
    if k2_prior + k2_fov != model["launches"]["matching_scores"]:
        raise AssertionError(f"K2 launches {model['launches']} are not the prior's and "
                             f"fov=180's ({k2_prior}, {k2_fov})")
    if cli_k["cli_train_VIGOR"]["K2"]:
        raise AssertionError(f"VIGOR training launched K2: {cli_k['cli_train_VIGOR']}")
    # K2 in the CLI's prior settings (ori_noise 180 and 36): the full-bin
    # bottleneck stack; at fov=180 (ori_noise 0): the masked window at the
    # six scales and the full-bin stack, masked too
    summary[1]["launches_by_path"] = {"predict_batch": k2_prior,
                                      "cli_eval_VIGOR": cli_k["cli_eval_VIGOR_prior"]["K2"]}
    summary[2]["launches_by_path"] = {"predict_batch": k2_fov,
                                      "cli_eval_VIGOR": cli_k["cli_eval_VIGOR_fov180"]["K2"]}
    for row in summary[1:3]:
        row["launches"] = sum(row["launches_by_path"].values())
    # the KITTI and Oxford forwards: each kernel's row sums its times at the
    # preset's shapes (one all-bin forward) and counts its launches over the
    # preset's settings; the error is the model's stacks, kernel vs plain
    for preset, p in presets["presets"].items():
        stacks = max(r["max_abs_err"]["stacks"] for r in p["results"])
        for kernel, name, replaces in (("K1", "matching_epilogue", K1_REPLACES),
                                       ("K2", "matching_scores", K2_REPLACES)):
            rows = [r for r in p["times"] if r["kernel"] == kernel]
            if not rows:
                continue
            row = _summary(f"{name} ({kernel}), {preset}", rows, replaces, dev)
            row["launches_by_path"] = {
                "predict_batch": sum(r["launches"][name] for r in p["results"]),
                f"cli_{preset}": cli_k[f"cli_{preset}"][kernel]}
            row["launches"] = sum(row["launches_by_path"].values())
            row["launches_by_setting"] = {json.dumps(r["setting"]): r["launches"][name]
                                          for r in p["results"]}
            row["max_abs_err"] = stacks
            summary.append(row)
    # the bfloat16 instances: the train_options phase's VIGOR steps and the
    # options CLIs' train steps (their validation runs in float32)
    if options is not None:
        opts = cli["options"]

        def bf16(run, kernel):
            return run["launches"]["by_dtype"].get(f"{kernel} bfloat16", 0)

        paths = {
            "matching_epilogue (K1), VIGOR bf16": {
                "train_options": options["launches_bf16_k1"],
                "cli_train_VIGOR_bf16": sum(bf16(opts[r], "matching_epilogue")
                                            for r in ("vigor_first", "vigor_resumed"))},
            "matching_epilogue (K1), KITTI bf16": {
                "cli_train_KITTI_bf16": bf16(opts["KITTI"], "matching_epilogue")},
            "matching_scores (K2), KITTI bf16": {
                "cli_train_KITTI_bf16": bf16(opts["KITTI"], "matching_scores")},
            "matching_scores (K2), OxfordRobotCar bf16": {
                "cli_train_OxfordRobotCar_bf16": bf16(opts["OxfordRobotCar"],
                                                      "matching_scores")}}
        for row in kern["bf16_summary"]:
            row["launches_by_path"] = paths[row["name"]]
            row["launches"] = sum(row["launches_by_path"].values())
            summary.append(row)
    # every served request: the serve phase's counts by kernel
    if serve is not None:
        summary[0]["launches_by_path"]["serve"] = serve["launches"]["matching_epilogue"]
        summary[0]["launches"] += serve["launches"]["matching_epilogue"]
        summary[1]["launches_by_path"]["serve"] = serve["launches"]["matching_scores_prior"]
        summary[2]["launches_by_path"]["serve"] = serve["launches"]["matching_scores_fov"]
        for row in summary[1:3]:
            row["launches"] = sum(row["launches_by_path"].values())
    # the int8 VIGOR model: predict_batch at the three keys, and served
    if quant is not None:
        for path, q in (("quant_predict_batch", quant["launches"]),
                        ("quant_serve", quant["serve"]["launches"])):
            summary[0]["launches_by_path"][path] = q["matching_epilogue"]
            summary[1]["launches_by_path"][path] = q["matching_scores_prior"]
            summary[2]["launches_by_path"][path] = q["matching_scores_fov"]
        for row in summary[:3]:
            row["launches"] = sum(row["launches_by_path"].values())
    idle = [(row["name"], path) for row in summary
            for path, n in row["launches_by_path"].items() if not n]
    if idle:
        raise AssertionError(f"kernels not launched on their main path: {idle}")
    return summary


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
    presets = phase_model_presets(dev)
    train = phase_train(dev, args.out)
    options = phase_train_options(dev)
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_roots_") as tmp:
        roots = write_roots(tmp)
        data = phase_data(dev, roots)
        cli = phase_cli(dev, roots)
    timing = phase_timing(dev, net, args.out)
    serve = phase_serve(dev, net)
    quant = phase_quant(dev, net, args.out)
    summary = kernels_line(kern, model, presets, train, data, cli, dev, options, serve, quant)
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"device": dev, "kernels": {k: v for k, v in kern.items() if k != "max_err"},
             "model": model, "model_presets": presets, "train": train,
             "train_options": options, "data": data, "cli": cli, "timing": timing,
             "serve": serve, "quant": quant,
             "seconds": time.perf_counter() - t0}, indent=1))
    emit({"kernels": summary})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
