#!/usr/bin/env python3
"""Card gate of the PyTorch port (``ccvpe_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Every phase runs the port on the card and checks it: against the plain
PyTorch versions of the kernels, against the CPU, against itself (a resume,
a replayed graph, an export), and by launch counts.  It times nothing: the
port is measured by ``portbench/``.  Phases, each printing one JSON line:

1. device:  the card's name and power limit (``nvidia-smi``), torch and CUDA.
2. build:   ``nvcc`` builds the matching and the conv kernels from
   ``ccvpe_torch/csrc``.
3. kernels: each kernel, in every layout that takes the shape (warp, tile),
   against its plain PyTorch version on the card, at the VIGOR shapes
   (batch 8; K2 with the fov=180 masked window), the ori-prior bottleneck,
   the Oxford and KITTI masked windows at coarse and fine scales and ragged
   maps (the tile layouts also at batch 3, 41x41 and 66x66, 5 and 21 bins),
   with a zero row and, for a masked window, a row that is zero inside one
   bin's window only, in float32 and bfloat16; both replayed from a CUDA
   graph; then the layout each wrapper picks by itself at the main path's
   shapes (float32 at VIGOR's six scales, the bottleneck and the fov=180
   windows; bfloat16 at the VIGOR, KITTI and Oxford shapes of the bfloat16
   paths) against the plain version.
   conv:    the decoders' 3x3 conv kernel (``ops.conv_cuda``,
   ``csrc/conv3x3.cu``) at every decoder shape of VIGOR, KITTI and Oxford
   at batch 8 against a float64 conv (1e-5 of the output's largest
   magnitude, the card tests' bar); at each VIGOR and KITTI shape the
   backward's dgrad and wgrad (with the bias gradient) against float64
   ``conv2d_input``/``conv2d_weight``; the split-K and the direct kernel
   replayed from a CUDA graph.
4. model:   ``ccvpe_torch.api.load_model(preset="VIGOR", seed=0)`` on the
   card; ``predict_batch`` at batch 8 with ``ori_noise`` 180 and 36 and with
   ``fov=180``, counting 24 decoder conv launches in each and kernel
   launches by kernel and by layout (K1: tile
   at the three fine scales; K2 at fov=180: tile at four, warp at two), held
   against the same model with ``matching_impl="plain"`` (the plain
   matching and the conv modules); replayed calls without the heatmap,
   cuDNN's TF32 off and on, launching 24 convs, 6 K1 and no K2 a call; and a
   NANO model on the card held against the same model on the CPU.
   model_presets: the KITTI (16 bins, 2048-d descriptor; with and without
   a +-2-bin prior) and Oxford RobotCar (4x7 ground grid, centred window)
   presets at full width, batch 8, through the kernels against the plain
   versions (the same pose per sample), launches per kernel and layout,
   and each kernel at each of the preset's shapes against its plain version.
5. train:   the VIGOR train step (``ccvpe_torch.train.loop``) at batch 8 in
   float32, TF32 off, on seeded weights with calibrated BN statistics and
   GT synthesized on the card: (a) one step through K1 against the same
   step through the plain versions (loss parts, every gradient, the new BN
   statistics; 6 K1 launches, 3 tile and 3 warp); (b) seven steps with
   drop-connect (finite losses, everything moved, peak memory, 24 forward,
   24 dgrad and 24 wgrad launches of the decoder conv kernels a step; the
   step's CUDA graphs captured once and replayed by every later step,
   ``train.loop.STEP_COUNTS``);
   (c) one NANO step on the card against the CPU.
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
   the rounded master counted); (d) finite losses and peak memory of
   float32, bfloat16, bfloat16 with bfloat16 parameters and each remat
   scope over four steps.
   data:    the input pipeline on synthetic dataset roots written from
   seeds (``write_roots``; VIGOR's cross-area train split: 48 2048x1024 JPEG
   panoramas and 640x640 PNG tiles over two cities): ``VigorIndex`` ->
   ``VigorSampler`` -> ``Loader`` (8 threads) -> ``device_prefetch`` ->
   ``vigor.device_batch`` on the card ->
   ``make_train_step`` for one epoch of six steps (finite losses, K1
   launches); the host-to-device bytes per batch; one batch on the card
   against the CPU, the prefetched batch against the synchronous one; one
   KITTI batch through the alignment chain on the card against the CPU; one
   Oxford batch; the native decoder's batch path against PIL's when it
   builds (else its build error).
   cli:     the port's CLIs through ``main([...])`` on those roots, full
   width, batch 8, float32: ``ccvpe_torch.train_VIGOR`` trains an epoch of
   3 steps (validation included), checkpoints (bytes, the sidecar), resumes
   a second epoch with the restored model and Adam state checked bit for
   bit against the file, writes the reference's results
   files; its model, saved with ``CVMModel.save_torch``, evaluates at
   ``--ori_noise 180`` (the shipped frozen orientations), ``36`` and ``-f 180
   --ori_noise 0``; ``train_KITTI`` (``--device_augment``) and
   ``train_OxfordRobotCar`` train 2 steps and evaluate (KITTI's test1/test2,
   Oxford's three traversals).  Every eval runs through the kernels and
   again through the plain versions: the same pixel for every sample, equal
   distances, prob_at_gt within 1e-6, heading within 0.1 degree; launches
   by layout.  Then the training options:
   ``train_VIGOR --bf16 --bf16_params --remat --pretrained_b0`` (a B0 file
   written from the port's seeded encoder) trains 2 steps, checkpoints and
   resumes bit for bit (the float32 master included); ``api.load_model`` of
   that checkpoint directory serves through the kernels against the plain
   versions; ``train_KITTI --device_augment --bf16`` and
   ``train_OxfordRobotCar --bf16`` train 2 steps each (K2, and KITTI's K1
   at 256^2 x 32, in bfloat16 inside a model): finite losses, the exact
   bfloat16 launches by kernel and layout of their train steps, peak memory.
6. serve:   ``ccvpe_torch.serve`` on 127.0.0.1 with the ``model`` phase's
   VIGOR model at batch 8, ``max_wait_ms`` 5: 96 ``/predict`` requests from
   16 client threads over the keys (180, 360), (36, 360) and (180, 180),
   PNGs at model size and three at a raw size; every answer against
   ``predict_batch`` through the plain versions (the same pixel, heading
   0.1 degree, probability 1e-6); a 413 and a 408; dispatches and batch
   fill, 503s, K1/K2 launches.
7. quant:   int8 post-training quantization of a copy of the ``model``
   phase's VIGOR model (``CVMModel.quantize_int8`` on a seeded batch of two
   pairs), batch 8: what ``torch._int_mm`` refuses on this card;
   every int8 conv shape's int32 sums (``torch._int_mm`` over the int8
   im2col) against the plain version (a float64 conv), exactly;
   ``predict_batch`` at the serve keys through K1/K2 against the plain
   matching (the same pixel per sample, the ``model`` phase's heatmap and
   heading gates, the other outputs within ``QUANT_FLIP_SHARE`` of the int8
   model's distance from float32; K1/K2 launches and int8 products counted
   from 0 at each key); the int8 readout's distance from the float32
   model's (not gated); peak memory of both models;
   ``python -m ccvpe_torch.serve --quantize int8 --calib_dir`` (through
   ``serve.main`` on the same weights) answering 48 requests, each equal to
   the served model's own ``predict_batch``.
8. parallel (after ``cli``): multi-device training and serving on the one
   card.  (a) Two spawned ranks join a gloo group through
   ``parallel.mesh.maybe_init_distributed`` and share the H100 (NCCL
   refuses two ranks on one GPU): VIGOR at full width, global batch 8 (4 a
   rank), f32, TF32 off, drop-connect off; two steps each of DDP, ZeRO-1
   and ``grad_accum=2``, each held on both ranks to the
   one-process batch-8 steps (the first step's loss parts 1e-5, every
   gradient after DDP's reduction 1e-3·‖g‖ + 1e-6·grad_norm, BN statistics
   1e-5; the second step's loss parts 1e-4, ``LATER_STEP_RTOL``; ZeRO-1's
   parameters to DDP's within 1e-6 relative), K1 launched per forward as
   the one-process forward launches it; peak GiB and bytes all-reduced per
   rank, labelled as two ranks sharing one card; (b)
   ``n_model=2`` (FSDP2 over gloo) on the same ranks, held the same way;
   (c) ``Trainer``'s two steps under a one-rank NCCL group against the same
   steps without a group, bit for bit (cuDNN deterministic); (d)
   ``CVMModel(mesh=[cuda:0, cuda:0])`` at the serve keys against the
   one-device model (the same pixel, heatmap 1e-7, heading 0.1°), a batch
   of one on the first replica alone, and ``serve --mesh data`` answering
   as ``predict_batch``.
9. visualize (after ``cli``, on the same roots): ``python -m
   ccvpe_torch.visualize``'s forward, ``predict_sample``, at full width:
   VIGOR (the ``model`` phase's model) at ``--ori_noise 180`` (the shipped
   frozen orientations) and ``36``, one KITTI and one Oxford sample; each
   through the kernels against the plain versions (the same
   ``loc_pred``/``loc_gt`` and GT, heatmap 1e-7, orientation 1e-3), K1/K2
   launches by kernel and layout.  ``render`` is not run on the card (its
   machine has no matplotlib); it is tested on the CPU.
10. export (after ``quant``): ``api.export_model`` of the ``model`` phase's
   VIGOR model at batch 8 and at ``batch="dynamic"`` (served at 8 and 3)
   and of the ``quant`` phase's int8 model at batch 8, reloaded with
   ``api.load_exported``: each answer equal to the same model's
   ``predict_batch`` through the plain matching exactly (the export traces
   the plain matching by design: no K1/K2 launch) and to the kernel path's
   at the ``model`` phase's gates.
11. backbones: ``EfficientNet("b1")`` ... ``("b7")`` at their own
   resolutions, batch 2, float32, TF32 off, BN calibrated on that batch,
   against the CPU at batch 1 (``phase_backbones``).

Then the ``kernels`` summary line (each kernel's checks and its launches
on each main path, counted from 0 just before that path ran; a kernel that
a main path did not launch fails the run), the raw ``nvidia-smi`` line
and, last, ``{"ok": true, "device": {...}}``.  Any failure raises: the
script then exits non-zero and prints no result line.  It needs one CUDA
device and ``nvcc``.

``--out DIR`` also writes the ptxas report and every check of the run
(``chip_smoke.json``) to ``DIR``.
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
from ccvpe_torch.ops import conv_cuda as CC
from ccvpe_torch.ops import gt as GT
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC
from ccvpe_torch.train import loop as TLOOP
from tests.torch_conv_shapes import decoder_conv_shapes

DEADLINE_S = 1100   # the whole run, build included, must end well inside 1200 s
BATCH = 8

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


# ---------------------------------------------------------------- phases


def phase_device() -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
    info = {"phase": "device", "nvidia_smi": smi, "name": torch.cuda.get_device_name(0),
            "power_limit": smi.split(",")[-1].strip(), "count": torch.cuda.device_count(),
            "torch": torch.__version__, "cuda": torch.version.cuda,
            "sms": torch.cuda.get_device_properties(0).multi_processor_count}
    emit(info)
    return info


def phase_build(out: Path | None) -> dict:
    info = {"phase": "build"}
    for name in ("matching", "conv3x3"):
        built = _build.build(name, force=True)
        regs = [int(m) for m in re.findall(r"Used (\d+) registers", built.log)]
        spill = [int(a) + int(b) for a, b in
                 re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", built.log)]
        row = {"nvcc_seconds": built.seconds, "library": str(built.path),
               "kernels_compiled": len(regs), "max_registers": max(regs, default=None),
               "kernels_spilling": sum(1 for n in spill if n)}
        if name == "matching":
            info.update(row)
        else:
            info[name] = row
        if out is not None:
            (out / ("ptxas.log" if name == "matching" else f"ptxas.{name}.log")).write_text(
                built.log)
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
    return ["warp", "tile"] if tile else ["warp"]


def _check_matching(kernel, b, hw, cs, cg, shift, offsets, window, seed,
                    dtype=torch.float32) -> dict:
    """``kernel`` ('K1' or 'K2') in the layout its wrapper picks by itself,
    held against the plain version in float32 on the same inputs."""
    x, g = _inputs(b, hw, cs, cg, seed, dtype)
    offsets = tuple(offsets)
    layout = MC.pick_layout(KERNEL_NAMES[kernel], x, cg, len(offsets))
    if kernel == "K1":
        got = MC.launch_matching_epilogue(x, g, shift, offsets, window)
        want = TM.matching_epilogue_plain(x.float(), g.float(), shift, offsets, window)
    else:
        got = (MC.launch_matching_scores(x, g, shift, offsets, window),)
        want = (TM.matching_scores_plain(x.float(), g.float(), shift, offsets, window),)
    torch.cuda.synchronize()
    err = _check(f"{kernel} {layout} x{[b, *hw, cs]} g{[b, cg]} {str(dtype)[6:]} (main path)",
                 got, want, dtype)
    return {"kernel": kernel, "dtype": str(dtype)[6:], "x": [b, *hw, cs], "g": [b, cg],
            "bins": len(offsets), "shift": shift, "window": window, "layout": layout,
            "max_abs_err": err}


def _summary(name, rows, replaces) -> dict:
    """One kernel row of the ``kernels`` line: the largest error of its
    checks at the shapes of ``rows`` (all of one dtype) and their layouts."""
    return {"name": name, "route": "cuda", "source": SOURCE, "replaces": replaces,
            "dtype": rows[0]["dtype"], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "checked_at": [r["x"] for r in rows], "layouts": [r["layout"] for r in rows]}


def _replay_check(tag: str, fn, launches, replays: int = 3) -> dict:
    """``fn`` captured as a CUDA graph (``ops.graphs.Graph``, as
    ``predict_batch`` captures its parts) and replayed: every output equal
    to the eager call's bit for bit, and ``launches()`` (a launch counter)
    grown by the eager call's launches at each replay and not at the
    capture."""
    from ccvpe_torch.ops.graphs import Graph

    with torch.inference_mode():
        before = launches()
        want = fn()
        torch.cuda.synchronize()
        per_call = launches() - before
        graph = Graph()
        got = graph.capture(fn, torch.cuda.graph_pool_handle())
        captured = launches() - before - per_call
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        for t in got:
            t.zero_()
        for _ in range(replays):
            graph.replay(got[0])
        torch.cuda.synchronize()
        counted = launches() - before - per_call
    if captured or counted != replays * per_call or not per_call:
        raise AssertionError(f"{tag}: {per_call} launches a call, {captured} counted at the "
                             f"capture, {counted} over {replays} replays")
    if not all(torch.equal(a, b) for a, b in zip(got, want)):
        raise AssertionError(f"{tag}: a replay differs from the eager call")
    return {"check": tag, "launches_per_call": per_call, "replays": replays,
            "launches_counted": counted}


def phase_kernels() -> dict:
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
    # both kernels replayed from a CUDA graph, as predict_batch runs them:
    # K1 at the finest VIGOR scale (tile), K2 with fov=180's masked window
    # at 32x32x320 (tile)
    x, g = _inputs(BATCH, (256, 256), 40, 40, 3, torch.float32)
    xs, gs = _inputs(BATCH, (32, 32), 320, 160, 4, torch.float32)
    graph_replays = [
        _replay_check("K1 tile 256x256x40", lambda: MC.launch_matching_epilogue(
            x, g, 2, tuple(range(20)), "first"), lambda: sum(MC.launch_counts().values())),
        _replay_check("K2 tile 32x32x320 masked", lambda: MC.launch_matching_scores(
            xs, gs, 16, tuple(range(20)), "first"), lambda: sum(MC.launch_counts().values()))]
    del x, g, xs, gs

    # the layout each wrapper picks at the main path's shapes: float32,
    # batch 8, 20 bins
    k1 = [_check_matching("K1", BATCH, (s, s), cs, cs, shift, range(20), "first", 20 + i)
          for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    k2 = [_check_matching("K2", BATCH, (8, 8), 1280, 1280, 64, range(20), "first", 30)]
    # the limited-fov setting: K2 with the masked window at every scale
    k2_fov = [_check_matching("K2", BATCH, (s, s), cs, cs // 2, shift, range(20), "first", 40 + i)
              for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    # bfloat16 at the shapes of the bf16 main paths (train_options, cli):
    # VIGOR's six K1 scales; KITTI's and Oxford's scales (K1 where Cg == Cs)
    bf16 = {"VIGOR": [_check_matching("K1", BATCH, (s, s), cs, cs, shift, range(20), "first",
                                      70 + i, torch.bfloat16)
                      for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]}
    for preset in ("KITTI", "OxfordRobotCar"):
        pc = cvm.PRESETS[preset]
        bf16[preset] = [_check_matching("K1" if cg == cs else "K2", BATCH, (side, side), cs, cg,
                                        shift, range(pc.bins), pc.window, 80 + i, torch.bfloat16)
                        for i, (side, cs, cg, shift) in enumerate(preset_scales(pc))]
    emit({"phase": "kernel_checks", "n": len(checks),
          "tolerance": {"float32": F32_TOL, "bfloat16": BF16_TOL},
          "max_abs_err": {f"{k} {str(d)[6:]}": v for (k, d), v in max_err.items()},
          "graph_replays": graph_replays,
          "main_path_layouts": {"K1": [r["layout"] for r in k1],
                                "K2_fov180": [r["layout"] for r in k2_fov]}})

    bf16_rows = []
    for preset, rows in bf16.items():
        for kernel in ("K1", "K2"):
            mine = [r for r in rows if r["kernel"] == kernel]
            if mine:
                bf16_rows.append(_summary(f"{KERNEL_NAMES[kernel]} ({kernel}), {preset} bf16",
                                          mine, K1_REPLACES if kernel == "K1" else K2_REPLACES))

    # K2 in two rows: its one launch per ori-prior forward (the full-bin
    # bottleneck stack) and its six per fov=180 forward (masked windows), so
    # that each row's checks and launches describe the same work
    return {"checks": checks, "graph_replays": graph_replays, "shapes": k1 + k2 + k2_fov,
            "bf16_shapes": bf16, "bf16_summary": bf16_rows,
            "summary": [_summary("matching_epilogue (K1)", k1, K1_REPLACES),
                        _summary("matching_scores (K2), ori-prior bottleneck", k2, K2_REPLACES),
                        _summary("matching_scores (K2), fov=180 masked window", k2_fov,
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


CONV_SOURCE = "ccvpe_torch/csrc/conv3x3.cu"
CONV_REPLACES = "none: the JAX package leaves the decoders' 3x3 convs to XLA"
# a float32 sum of up to 12096 products in the kernel's order against the
# float64 sum, relative to the output's largest magnitude: the card tests'
# bar (tests/test_torch_conv_cuda.py)
CONV_REL_TOL = 1e-5
CONV_PRESETS = {"VIGOR": cvm.VIGOR, "KITTI": cvm.KITTI, "OxfordRobotCar": cvm.OXFORD}


def _conv_inputs(b, h, w, cin, cout, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn((b, cin, h, w), generator=gen, device="cuda").relu()
    wt = torch.randn((cout, cin, 3, 3), generator=gen, device="cuda") / (9 * cin) ** 0.5
    bias = torch.randn((cout,), generator=gen, device="cuda") * 0.1
    return x.contiguous(memory_format=torch.channels_last), wt, bias


def _conv_launches() -> int:
    return sum(CC.launch_counts().values())


def _conv_backward(x, wt) -> dict:
    """dgrad and wgrad (``ops.conv_cuda._dgrad``, ``_wgrad``) of one shape
    against float64 ``conv2d_input`` / ``conv2d_weight`` and the bias sum."""
    b, cin, h, w = x.shape
    cout = wt.shape[0]
    gen = torch.Generator(device="cuda").manual_seed(cin * 7919 + cout)
    gy = torch.randn((b, cout, h, w), generator=gen, device="cuda").contiguous(
        memory_format=torch.channels_last)
    with torch.no_grad():
        dx = CC._dgrad(gy, wt)
        dw, db = CC._wgrad(x, gy)
    g64 = gy.double()
    errs = {}
    for name, got, want in (
            ("dgrad", dx, torch.nn.grad.conv2d_input(tuple(x.shape), wt.double(), g64, padding=1)),
            ("wgrad", dw, torch.nn.grad.conv2d_weight(x.double(), tuple(wt.shape), g64,
                                                      padding=1)),
            ("bias", db, g64.sum((0, 2, 3)))):
        errs[name] = (got.double() - want).abs().max().item() / want.abs().max().item()
        if not errs[name] <= CONV_REL_TOL:
            raise AssertionError(f"conv3x3 {name} {[b, h, w, cin, cout]}: error {errs[name]} "
                                 f"of the largest gradient (bar {CONV_REL_TOL})")
    return {"dgrad_launch": CC.choose_plan(b, h, w, cout, cin)._asdict(),
            "wgrad_launch": CC.choose_wgrad_plan(b, h, w, cin, cout)._asdict(),
            "dgrad_rel_err": errs["dgrad"], "wgrad_rel_err": max(errs["wgrad"], errs["bias"])}


def phase_conv(dev: dict) -> dict:
    """The decoders' 3x3 conv kernel (``ops.conv_cuda.conv3x3``) at every
    decoder shape of VIGOR, KITTI and Oxford at batch 8, against a float64
    conv on the card (the first conv of a pair with its ReLU, as the model
    runs it); at each VIGOR and KITTI shape the backward's dgrad and wgrad
    (``_conv_backward``).  Oxford's shapes are VIGOR's."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    errs, info = {}, {"phase": "conv", "card": dev["nvidia_smi"], "batch": BATCH,
                      "dtype": "float32", "rel_tolerance": CONV_REL_TOL, "presets": {}}
    for preset, cfg in CONV_PRESETS.items():
        rows = []
        for i, (name, shape) in enumerate(decoder_conv_shapes(cfg, BATCH)):
            b, h, w, cin, cout = shape
            relu = name.endswith(".0")
            launch = CC.choose_plan(b, h, w, cin, cout)
            x, wt, bias = _conv_inputs(*shape, seed=i)
            if (shape, relu) not in errs:
                before = _conv_launches()
                with torch.inference_mode():
                    got = CC.conv3x3(x, wt, bias, relu)
                want = CC.conv3x3_plain(x.double(), wt.double(), bias.double(), relu)
                err = (got.double() - want).abs().max().item() / want.abs().max().item()
                if (_conv_launches() - before != 1 or not got.permute(0, 2, 3, 1).is_contiguous()
                        or not err <= CONV_REL_TOL):
                    raise AssertionError(f"conv3x3 {preset} {name} {shape} {launch}: error "
                                         f"{err} of the largest output (bar {CONV_REL_TOL})")
                errs[(shape, relu)] = err
                del got, want
            if preset != "OxfordRobotCar":
                rows.append({"conv": name, "shape": list(shape), "relu": relu,
                             "launch": launch._asdict(), "rel_err": errs[(shape, relu)],
                             **_conv_backward(x, wt)})
            del x, wt, bias
        checked = [errs[(s, n.endswith(".0"))] for n, s in decoder_conv_shapes(cfg, BATCH)]
        entry = {"max_rel_err": max(checked), "rows": rows}
        if rows:
            entry["max_backward_rel_err"] = max(max(r["dgrad_rel_err"], r["wgrad_rel_err"])
                                                for r in rows)
        info["presets"][preset] = entry
    # the split-K and the direct kernel replayed from a CUDA graph, as
    # predict_batch runs them
    info["graph_replays"] = []
    for shape, relu in (((BATCH, 16, 16, 1344, 640), True), ((BATCH, 512, 512, 16, 2), False)):
        x, wt, bias = _conv_inputs(*shape, seed=5)
        info["graph_replays"].append(_replay_check(
            f"conv3x3 {list(shape)} {CC.choose_plan(*shape[:5]).plan}",
            lambda: CC.conv3x3(x, wt, bias, relu), _conv_launches))
        del x, wt, bias
    torch.cuda.empty_cache()
    emit({**info, "presets": {k: {m: v for m, v in e.items() if m != "rows"}
                              for k, e in info["presets"].items()}})
    return info


REPLAYS = 3     # replayed predict_batch calls whose launches are counted


def phase_model() -> dict:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = api.load_model(preset="VIGOR", seed=0)
    if model.device.type != "cuda":
        raise AssertionError(f"load_model chose {model.device}, not cuda")
    _calibrate(model, seed=1)
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
    # just before it and read just after: a call on other images first
    # (eager; it captures the setting's CUDA graphs), then the counted call,
    # which replays them
    poses, steps, layout_steps = [], [], []
    launches = dict.fromkeys(MC.launch_counts(), 0)
    conv_steps = []
    warm_grd, warm_sat = _images(model.cfg, BATCH, seed=12)
    for kw, _ in settings:
        model.predict_batch(warm_grd, warm_sat, return_heatmap=True, **kw)
        MC.reset_launch_counts()
        conv0 = _conv_launches()
        poses.append(model.predict_batch(grd, sat, return_heatmap=True, **kw))
        conv_steps.append(_conv_launches() - conv0)
        counts = MC.launch_counts()
        steps.append((counts["matching_epilogue"], counts["matching_scores"]))
        layout_steps.append({k: n for k, n in MC.launch_counts("layout").items() if n})
        for k in launches:
            launches[k] += counts[k]
    if steps != [w for _, w in settings]:
        raise AssertionError(f"kernel launches (K1, K2) per setting {steps}, "
                             f"want {[w for _, w in settings]}")
    if conv_steps != [24] * len(settings):
        raise AssertionError(f"decoder conv launches per setting {conv_steps}, want 24 each")
    if not model.uses_graphs() or len(model.graphs) != len(settings):
        raise AssertionError(f"predict_batch holds {len(model.graphs)} graph signatures, want "
                             f"one a setting ({len(settings)})")
    for (kw, _), got in zip(settings, layout_steps):
        k1 = {k: n for k, n in got.items() if k[0] == "matching_epilogue"}
        if "fov" not in kw and k1 != k1_layouts:
            raise AssertionError(f"VIGOR {kw}: K1 launches by layout {k1}, want {k1_layouts}")
        k2 = {k: n for k, n in got.items() if k[0] == "matching_scores"}
        if "fov" in kw and k2 != k2_fov_layouts:
            raise AssertionError(f"VIGOR {kw}: K2 launches by layout {k2}, want {k2_fov_layouts}")
    # replayed calls without the heatmap, cuDNN's TF32 off and on (each a
    # signature of its own, captured by the first call)
    replayed = {}
    for label, tf32 in (("tf32_off", False), ("cudnn_tf32_default", True)):
        torch.backends.cudnn.allow_tf32 = tf32
        model.predict_batch(warm_grd, warm_sat)
        before = _conv_launches(), MC.launch_counts()
        for _ in range(REPLAYS):
            model.predict_batch(grd, sat)
        after = _conv_launches(), MC.launch_counts()
        per_call = {"conv3x3": (after[0] - before[0]) / REPLAYS,
                    **{k: (v - before[1][k]) / REPLAYS for k, v in after[1].items()}}
        if per_call != {"conv3x3": 24, "matching_epilogue": 6, "matching_scores": 0}:
            raise AssertionError(f"{label}: launches a replayed call {per_call}")
        replayed[label] = per_call
    torch.backends.cudnn.allow_tf32 = False

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
            "graph_signatures": len(model.graphs), "launches": launches,
            "launches_per_replayed_call": replayed,
            "conv_launches_per_setting": conv_steps,
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
    centred window); then each kernel at each of the preset's shapes against
    its plain version, in the layout its wrapper picks."""
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
        warm_grd, warm_sat = _images(model.cfg, BATCH, seed=12)
        for kw in settings:
            prior = kw["ori_noise"] < 180
            # the first call captures the setting's graphs; the counted one replays
            model.predict_batch(warm_grd, warm_sat, return_heatmap=True, **kw)
            MC.reset_launch_counts()
            conv0 = _conv_launches()
            poses = model.predict_batch(grd, sat, return_heatmap=True, **kw)
            conv = _conv_launches() - conv0
            launches = MC.launch_counts()
            if conv != 24:
                raise AssertionError(f"{preset} {kw}: {conv} decoder conv launches, want 24")
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
            results.append({"setting": kw, "launches": launches, "conv_launches": conv,
                            "launches_by_layout": by_layout,
                            "rows": [p.row for p in poses], "cols": [p.col for p in poses],
                            "max_abs_err": errs, "heading_err_deg": heading,
                            "logit_spread_min": out.logits_flattened.std(dim=1).min().item()})
        if len(model.graphs) != len(settings):
            raise AssertionError(f"{preset}: {len(model.graphs)} graph signatures, want "
                                 f"{len(settings)}")
        shapes = [_check_matching("K1" if cg == cs else "K2", BATCH, (side, side), cs, cg, shift,
                                  range(model.cfg.bins), model.cfg.window, 60 + i)
                  for i, (side, cs, cg, shift) in enumerate(scales)]
        info["presets"][preset] = {"results": results, "shapes": shapes,
                                   "graph_signatures": len(model.graphs)}
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
TRAIN_STEPS = 7


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


def phase_train(dev: dict) -> dict:
    """The VIGOR train step at full width, batch 8, float32, on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cvm.VIGOR
    state = _calibrated_state(cfg, seed=0)
    if next(state.model.parameters()).device.type != "cuda":
        raise AssertionError("create_train_state did not place the model on cuda")
    plain = TLOOP.create_train_state(cfg, seed=0)
    plain.model.load_state_dict(state.model.state_dict())
    data = _train_batch(cfg, BATCH, seed=2, device="cuda")

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
    torch.cuda.reset_peak_memory_stats()
    MC.reset_launch_counts()
    passes0 = CC.pass_counts()
    steps0 = TLOOP.step_counts()
    step_parts = [k_step(state, _normalized(data), gen) for _ in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    # a warm-up, a capture, then replays of the step's CUDA graphs
    steps = {k: v - steps0[k] for k, v in TLOOP.step_counts().items()}
    if (steps["captured"] < 1 or sum(steps.values()) != TRAIN_STEPS
            or steps["replayed"] != TRAIN_STEPS - steps["captured"] - steps["eager"]):
        raise AssertionError(f"{TRAIN_STEPS} train steps ran {steps}: want a capture and "
                             "the rest replayed")
    launches = MC.launch_counts()
    if launches != {"matching_epilogue": 6 * TRAIN_STEPS, "matching_scores": 0}:
        raise AssertionError(f"{TRAIN_STEPS} train steps launched {launches}")
    # the decoders' 24 convs of a step: forward, dgrad and wgrad on the kernels
    passes = {k: (v - passes0[k]) / TRAIN_STEPS for k, v in CC.pass_counts().items()}
    if passes != {"forward": 24, "dgrad": 24, "wgrad": 24}:
        raise AssertionError(f"a train step launched the decoder conv kernels {passes} "
                             "times by pass, want 24 each")
    loss_values = [p["loss"].item() for p in step_parts]
    if not all(math.isfinite(v.item()) for p in step_parts for v in p.values()):
        raise AssertionError(f"non-finite loss parts: {step_parts}")
    # every parameter and BN statistic moved, except the _fc heads (no gradient)
    after = state.model.state_dict()
    stay = {k for k in before if not k.endswith("num_batches_tracked")
            and torch.equal(before[k], after[k])}
    want_stay = {k for k in before if "._fc." in k}
    if stay != want_stay:
        raise AssertionError(f"these stayed through {TRAIN_STEPS} steps: "
                             f"{sorted(stay ^ want_stay)[:8]}")
    del before, after
    info = {"phase": "train", "card": dev["nvidia_smi"], "preset": "VIGOR", "batch": BATCH,
            "dtype": "float32", "tolerance": TRAIN_TOL,
            "kernel_vs_plain": {**check, "launches_by_layout": {
                f"{k} {lay}": n for (k, lay), n in k_layouts.items()}},
            "steps": TRAIN_STEPS, "step_counts": steps, "launches": launches,
            "conv_launches_per_step": passes,
            "losses": loss_values,
            "max_memory_allocated_gib": torch.cuda.max_memory_allocated() / 2 ** 30}
    emit({k: v for k, v in info.items() if k != "losses"})
    info["nano"] = phase_train_nano()
    # give the trainer's memory back before the next phase
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


# train_options: the remat steps against the step without remat (float32,
# drop-connect on): the same forward, so the loss parts agree to rounding;
# cuDNN's weight gradients may sum in another order on each run
REMAT_TOL = {"loss_rtol": 1e-6, "grad_rel": 1e-4, "grad_abs": 1e-7, "bn": 1e-6}
OPTION_STEPS = 4          # steps per configuration in (d)
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


def _option_steps(state, step, batch, gen) -> dict:
    """OPTION_STEPS steps with finite loss parts, and the peak memory
    allocated during them."""
    torch.cuda.synchronize()
    resident = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    parts = [step(state, batch, gen) for _ in range(OPTION_STEPS)]
    if not all(math.isfinite(v.item()) for p in parts for v in p.values()):
        raise AssertionError(f"non-finite loss parts: {parts}")
    return {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
            "peak_over_resident_gib": (torch.cuda.max_memory_allocated() - resident) / 2 ** 30}


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
    bf16 parameters with the float32 master; (d) finite losses and peak
    memory of each configuration."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = cvm.VIGOR
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

    # (d) finite losses and peak memory per configuration, drop-connect on
    configs = {"float32": ({}, None), "bf16": (dict(compute_dtype="bfloat16"), None),
               "bf16+bf16_params": (dict(compute_dtype="bfloat16"), "bfloat16"),
               "remat_all": (dict(remat="all"), None),
               "remat_encoder": (dict(remat="encoder"), None),
               "remat_decoder": (dict(remat="decoder"), None)}
    info["configs"] = {}
    MC.reset_launch_counts()
    for name, (kw, param_dtype) in configs.items():
        state = (TLOOP.train_state_from_torch(base.model.state_dict(), cfg,
                                              param_dtype=param_dtype)
                 if param_dtype else copy.deepcopy(base))
        info["configs"][name] = _option_steps(state, TLOOP.make_train_step(cfg, **kw), data, gen)
        del state
        gc.collect()
        torch.cuda.empty_cache()
    bf16_launches += MC.launch_counts("dtype")["matching_epilogue", "bfloat16"]
    info["launches_bf16_k1"] = bf16_launches
    emit(info)
    del base, data
    gc.collect()
    torch.cuda.empty_cache()
    return info


DATA_TOL = 1e-6           # a device batch on the card against the same batch on the CPU
FED_STEPS = 6             # one epoch of the synthetic VIGOR root: 48 panoramas, batch 8


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
            "pil": PIL.__version__, "workers": 8, "tolerance": DATA_TOL}
    index = DV.VigorIndex.load(roots["vigor"], "crossarea", train=True)
    sampler = DV.VigorSampler(index, pos_only=False)
    order = DP.epoch_indices(len(index), shuffle=True, rng=np.random.default_rng(0))

    def loader(**kw):
        return DP.Loader(sampler, order, batch_size=BATCH, num_workers=8, **kw)

    # the loader alone: host decode, resize and collation, no device work
    hosts = list(loader(native_batch=False))
    if len(hosts) != FED_STEPS:
        raise AssertionError(f"{len(hosts)} batches from {len(index)} panoramas")
    info["h2d_bytes_per_batch"] = sum(v.nbytes for v in hosts[0].values()
                                      if v.dtype.kind in "biuf")

    # one batch on the card against the same batch on the CPU
    fn = lambda raw: DV.device_batch(raw, train=True, device="cuda")
    sync = fn(hosts[0])
    info["device_batch_max_abs_err"] = _check_batch(
        "VIGOR device batch", sync, DV.device_batch(hosts[0], train=True, device="cpu"),
        DATA_TOL)

    # the main path: an epoch of steps fed from the root, the batch
    # assembled on the side stream
    state = _calibrated_state(cvm.VIGOR, seed=0)
    step = TLOOP.make_train_step(cvm.VIGOR)
    gen = torch.Generator(device="cuda").manual_seed(7)
    sampler.set_epoch(0)
    MC.reset_launch_counts()
    losses = []
    for i, batch in enumerate(DP.device_prefetch(loader(native_batch=False), fn, device="cuda")):
        if i == 0:
            info["prefetched_equals_synchronous"] = {
                k: torch.equal(batch[k], v) for k, v in sync.items()}
        losses.append(step(state, batch, gen)["loss"].item())
    launches = MC.launch_counts()
    if launches != {"matching_epilogue": 6 * FED_STEPS, "matching_scores": 0}:
        raise AssertionError(f"{FED_STEPS} fed steps launched {launches}")
    if not all(info["prefetched_equals_synchronous"].values()):
        raise AssertionError(f"prefetched batch differs: {info['prefetched_equals_synchronous']}")
    if not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite losses {losses}")
    info["launches"], info["fed_losses"] = launches, losses
    del state, sync
    gc.collect()
    torch.cuda.empty_cache()

    # the native decoder's batch path (opt-in, as in the JAX package)
    if native_loader.available():
        native = list(loader(native_batch=True))
        diff = {k: int(np.abs(a[k].astype(int) - b[k].astype(int)).max())
                for a, b in zip(native[:1], hosts[:1]) for k in ("grd", "sat")}
        for a, b in zip(native, hosts):
            for k in ("rotation", "angle", "row_offset", "col_offset", "city"):
                np.testing.assert_array_equal(a[k], b[k])
            for k in ("grd", "sat"):
                if np.abs(a[k].astype(int) - b[k].astype(int)).mean() >= 1.0:
                    raise AssertionError(f"native {k} differs from PIL's")
        info["native"] = {"ran": True, "max_abs_diff_vs_pil_first_batch": diff}
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
                                    {k: v for k, v in cpu.items() if k != "sat"}, DATA_TOL)}
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

    return {
        "vigor": synthetic.write_vigor_root(
            f"{tmp}/vigor", panos_per_city=24, sats_per_city=24, pano_hw=(1024, 2048),
            sat_hw=(640, 640), pano_ext=".jpg", span=300.0, seed=0),
        "kitti": synthetic.write_kitti_root(f"{tmp}/kitti", n=2 * BATCH, n_test=2 * BATCH,
                                            grd_hw=(375, 1242), sat_hw=(1280, 1280), seed=1),
        "oxford": synthetic.write_oxford_root(f"{tmp}/oxford/", n=3 * BATCH, map_hw=(4000, 4000),
                                              grd_hw=(960, 1280), test_frames=BATCH, seed=2)}


class _CliProbe:
    """While active, records what the CLIs' harness does, without a host
    sync in its loops: each trainer, each train epoch, each step's loss (on
    the card), each eval pass's readout dicts (on the card); each resume is
    checked bit for bit against the file it restored."""

    def __init__(self):
        self.trainers, self.epochs, self.losses, self.readouts = [], [], [], []
        self.resumes = []
        self._undo = []

    def _patch(self, owner, name, wrap):
        orig = getattr(owner, name)
        setattr(owner, name, wrap(orig))
        self._undo.append((owner, name, orig))

    def __enter__(self):
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
                out = orig(self, loader, fn, epoch)
                probe.epochs.append(epoch)
                return out
            return wrapped

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
        self._patch(harness.Trainer, "resume", resume)
        return self

    def __exit__(self, *exc):
        for owner, name, orig in reversed(self._undo):
            setattr(owner, name, orig)
        return False

    def clear(self):
        for records in (self.trainers, self.epochs, self.losses, self.readouts):
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
                      "readout": _readouts(probe)}
    if runs["plain"]["launches"]["K1"] or runs["plain"]["launches"]["K2"]:
        raise AssertionError(f"{tag}: the plain run launched {runs['plain']['launches']}")
    return {"check": _kernel_vs_plain(tag, runs), "launches": runs["kernel"]["launches"],
            "median_distance_m": {s: v["median_distance_m"]
                                  for s, v in runs["kernel"]["summary"].items()}}


def _train_cli(tag, main, argv, probe, want_steps: int) -> dict:
    """One train CLI run: finite losses, the steps taken, the epochs, the
    launches and the peak memory allocated."""
    probe.clear()
    MC.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    main(argv)
    losses = torch.stack(probe.losses).tolist()
    if len(losses) != want_steps or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"{tag}: losses {losses}, want {want_steps} finite")
    return {"losses": losses, "epochs": list(probe.epochs), "launches": _launches(),
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
        if resumed["epochs"] != [1] or len(probe.resumes) != 1:
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
            "checkpoint_bytes": ckpt_bytes, "results_lines": summary_lines}
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
    emit(info)
    return info


PARALLEL_RANKS = 2
PARALLEL_STEPS = 2
# ZeRO-1 against the replicated run (the same products, cuDNN deterministic;
# Adam on slices): each parameter within 1e-6 of its norm
ZERO1_PARAM_RTOL = 1e-6
# a second step starts from weights that two correct runs leave apart: where
# a gradient is near Adam's eps, its reduction order (two ranks' halves
# against one batch) can flip the update's sign, a whole lr step; the
# second step's loss parts are held at 1e-4 (the first step at TRAIN_TOL)
LATER_STEP_RTOL = 1e-4
# the cases each rank runs: (name, state options, grad_accum, reference)
PARALLEL_CASES = (("ddp", {}, 1, 1), ("zero1", {"zero1": True}, 1, 1),
                  ("accum", {}, 2, 2), ("n_model", {"n_model": 2}, 1, 1))
GLOO_LABEL = "two ranks sharing one H100 over gloo (not a multi-GPU speed)"


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _snapshot(state) -> dict:
    """The first step's gradients (whole, on the host) and BN statistics."""
    from ccvpe_torch.parallel.distribute import full_tensor

    grads = {k: full_tensor(p.grad).detach().float().cpu()
             for k, p in state.model.named_parameters() if p.grad is not None}
    bn = {k: v.detach().cpu().clone() for k, v in state.model.named_buffers()
          if k.endswith(("running_mean", "running_var"))}
    return {"grads": grads, "bn": bn}


def _params(state) -> dict:
    from ccvpe_torch.parallel.distribute import full_tensor

    return {k: full_tensor(p).detach().float().cpu() for k, p in state.model.named_parameters()}


def _held(tag, parts, snap, ref, tol=TRAIN_TOL) -> dict:
    """Loss parts of every step, the first step's gradients and BN
    statistics against the one-process reference (``_parallel_refs``)."""
    errs = {}
    for i, (got, want) in enumerate(zip(parts, ref["parts"], strict=True)):
        rtol = tol["loss_rtol"] if i == 0 else LATER_STEP_RTOL
        for k, v in want.items():
            a = got[k]
            if not (math.isfinite(a) and abs(a - v) <= rtol * abs(v)):
                raise AssertionError(f"{tag}: step {i + 1} {k} {a} vs {v}")
            errs[f"{k}_{i + 1}"] = abs(a - v) / abs(v)
    grad_norm = ref["parts"][0]["grad_norm"]
    if set(snap["grads"]) != set(ref["grads"]):
        raise AssertionError(f"{tag}: gradients of {sorted(set(snap['grads']) ^ set(ref['grads']))[:4]}")
    worst = 0.0
    for k, want in ref["grads"].items():
        d = (snap["grads"][k] - want).norm().item()
        lim = tol["grad_rel"] * want.norm().item() + tol["grad_abs"] * grad_norm
        if not d <= lim:
            raise AssertionError(f"{tag}: gradient of {k} differs by {d} > {lim}")
        worst = max(worst, d / lim)
    bn_err = 0.0
    for k, want in ref["bn"].items():
        torch.testing.assert_close(snap["bn"][k], want, atol=tol["bn"], rtol=tol["bn"],
                                   msg=lambda m, k=k: f"{tag}: {k}: {m}")
        bn_err = max(bn_err, (snap["bn"][k] - want).abs().max().item())
    return {"loss_parts_rel_err": errs, "gradient_tensors": len(ref["grads"]),
            "worst_gradient_err_over_limit": worst, "bn_max_abs_err": bn_err}


def _parallel_refs(cfg, d: str, device, span: float) -> dict:
    """One process, no process group: the start (seeded weights, calibrated
    BN statistics) and the global batch written for the ranks, and the
    reference steps at the global batch: two plain steps, two of
    ``grad_accum=2``.  Returns the K1/K2 launches per forward of each."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    state = _calibrated_state(cfg, seed=0, device=device)
    sd = {k: v.detach().cpu().clone() for k, v in state.model.state_dict().items()}
    batch = _normalized(_train_batch(cfg, BATCH, seed=2, device=device, span=span))
    torch.save({"model": sd, "batch": {k: v.cpu() for k, v in batch.items()}},
               f"{d}/inputs.pt")
    del state
    info = {}
    for accum in (1, 2):
        st = TLOOP.train_state_from_torch(sd, cfg, device=device)
        step = TLOOP.make_train_step(cfg, grad_accum=accum)
        steps = PARALLEL_STEPS
        parts, snap = [], None
        MC.reset_launch_counts()
        for i in range(steps):
            p = step(st, batch)
            parts.append({k: v.item() for k, v in p.items()})
            if i == 0:
                snap = _snapshot(st)
        per_forward = {k: n // (steps * accum) for k, n in MC.launch_counts().items()}
        if cfg.name == "VIGOR" and per_forward != {"matching_epilogue": 6, "matching_scores": 0}:
            raise AssertionError(f"the one-process VIGOR step launched {per_forward} a forward")
        torch.save({"parts": parts, **snap, "params": _params(st),
                    "launches_per_forward": per_forward}, f"{d}/ref_{accum}.pt")
        info[f"grad_accum_{accum}_launches_per_forward"] = per_forward
        del st
    return info


def _parallel_rank(rank: int, world: int, port: int, d: str, cfg_name: str, device: str) -> None:
    """One rank of the ``parallel`` phase, a process of its own: joins the
    gloo group through ``maybe_init_distributed`` (the launch environment
    set here, as ``torchrun`` sets it) and runs every case of
    ``PARALLEL_CASES`` on its half of the global batch, each held to the
    one-process reference; writes ``rank{r}.json``."""
    import faulthandler

    from ccvpe_torch.parallel import mesh

    faulthandler.enable()   # a crash in a rank prints where it was
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port), LOCAL_RANK="0")
    if not mesh.maybe_init_distributed(backend="gloo"):
        raise AssertionError("maybe_init_distributed did not join the group")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # deterministic convolutions: ZeRO-1's run repeats DDP's products exactly
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cuda = torch.device(device).type == "cuda"
    cfg = cvm.PRESETS[cfg_name]
    inp = torch.load(f"{d}/inputs.pt", weights_only=True)
    sd = inp["model"]
    local = {k: v.to(device) for k, v in mesh.shard_batch(inp["batch"]).items()}
    refs = {a: torch.load(f"{d}/ref_{a}.pt", weights_only=True) for a in (1, 2)}
    out = {"rank": rank, "world": mesh.world_size(), "backend": torch.distributed.get_backend(),
           "label": GLOO_LABEL, "cases": {}}
    ddp_params = None
    for name, kw, accum, ref in PARALLEL_CASES:
        state = TLOOP.train_state_from_torch(sd, cfg, device=device, **kw)
        step = TLOOP.make_train_step(cfg, grad_accum=accum)
        steps = len(refs[ref]["parts"])
        if cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        MC.reset_launch_counts()
        mesh.reset_all_reduced_bytes()
        parts, snap = [], None
        for i in range(steps):
            p = step(state, local)
            parts.append({k: v.item() for k, v in p.items()})
            if i == 0:
                snap = _snapshot(state)
        # each forward launches what the one-process forward launches
        launches = MC.launch_counts()
        want = {k: n * accum * steps for k, n in refs[ref]["launches_per_forward"].items()}
        if launches != want:
            raise AssertionError(f"rank {rank} {name}: launches {launches}, want {want}")
        case = {"held": _held(f"rank {rank} {name}", parts, snap, refs[ref]),
                "launches": launches,
                "launches_by_layout": {f"{k} {lay}": n for (k, lay), n
                                       in MC.launch_counts("layout").items() if n},
                "bn_and_loss_all_reduced_bytes_per_step": mesh.all_reduced_bytes() // steps,
                "gradient_all_reduced_bytes_per_step": sum(
                    p.numel() * 4 for k, p in state.model.named_parameters() if "._fc." not in k)}
        if cuda:
            case["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
        params = _params(state)
        if name == "ddp":
            ddp_params = params
        if name == "zero1":
            worst = 0.0
            for k, want_p in ddp_params.items():
                err = (params[k] - want_p).norm().item()
                lim = ZERO1_PARAM_RTOL * want_p.norm().item()
                if not err <= lim:
                    raise AssertionError(f"rank {rank} zero1: {k} off the DDP run's by {err}")
                worst = max(worst, err / max(lim, 1e-30))
            case["params_vs_ddp_worst_over_limit"] = worst
            case["sharded_tensors"] = sum(ax is not None for ax in state.optimizer.axes)
        out["cases"][name] = case
        print(f"parallel rank {rank}: {name} held", file=sys.stderr, flush=True)
        del state, params
    with open(f"{d}/rank{rank}.json", "w") as f:
        json.dump(out, f)
    torch.distributed.destroy_process_group()


def _nccl_one_rank(port: int, d: str, cfg_name: str) -> None:
    """(c) ``Trainer``'s steps without a process group, then under a
    one-rank NCCL group joined through ``maybe_init_distributed``; cuDNN
    deterministic, so the two runs can be held bit for bit."""
    from ccvpe_torch.parallel import mesh
    from ccvpe_torch.train.harness import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    cfg = cvm.PRESETS[cfg_name]
    inp = torch.load(f"{d}/inputs.pt", weights_only=True)
    batch = {k: v.to("cuda") for k, v in inp["batch"].items()}

    def run():
        tr = Trainer(cfg, batch_size=BATCH, device="cuda")
        tr.state = TLOOP.train_state_from_torch(inp["model"], cfg, device="cuda")
        parts = [{k: v.item() for k, v in tr._train_step(tr.state, batch, None).items()}
                 for _ in range(PARALLEL_STEPS)]
        return parts, _params(tr.state)

    alone = run()
    os.environ.update(RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                      LOCAL_RANK="0")
    if not mesh.maybe_init_distributed():
        raise AssertionError("maybe_init_distributed did not join the one-rank group")
    out = {"backend": torch.distributed.get_backend(), "world": mesh.world_size()}
    grouped = run()
    torch.distributed.destroy_process_group()
    diffs = {k: (alone[1][k] - grouped[1][k]).abs().max().item() for k in alone[1]}
    worst = max(diffs, key=diffs.get)
    out.update(parts_alone=alone[0], parts_grouped=grouped[0],
               bitwise=alone[0] == grouped[0] and diffs[worst] == 0.0,
               largest_param_diff=diffs[worst], largest_param_diff_at=worst)
    with open(f"{d}/nccl.json", "w") as f:
        json.dump(out, f)


def _spawn(target, args_list, timeout_s: float) -> None:
    """Start one process per argument tuple (spawned), wait for all, and
    stop any left; raise unless every one exited 0."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=a) for a in args_list]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout_s
    try:
        for p in procs:
            p.join(max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * len(procs):
        raise AssertionError(f"{target.__name__} processes exited {codes}")


def _mesh_serving(model: api.CVMModel, tmp: str) -> dict:
    """(d) ``CVMModel(mesh=[dev, dev])`` (two replicas on the card) against
    the one-device model at the serve keys, a batch of one through the
    first replica alone, and ``python -m ccvpe_torch.serve --mesh data``
    (through ``serve.main``) answering requests as ``predict_batch``."""
    import concurrent.futures
    import multiprocessing
    import threading

    from ccvpe_torch import serve
    from ccvpe_torch.api import _prepare

    cfg, dev = model.cfg, model.device
    meshed = api.CVMModel(cfg, model.net, dev, mesh=[dev, dev])
    if len(meshed.replicas) != 2 or meshed.replicas[1].net is model.net:
        raise AssertionError("the mesh model did not make two replicas")
    grd, sat = _images(cfg, BATCH, 71)
    MC.reset_launch_counts()
    counts, worst = {}, {"heatmap": 0.0, "heading": 0.0}
    for noise, fov in SERVE_KEYS:
        kw = dict(ori_noise=noise, fov=fov, return_heatmap=True)
        before = MC.launch_counts()
        got = meshed.predict_batch(grd, sat, **kw)
        counts[json.dumps([noise, fov])] = {k: n - before[k] for k, n in MC.launch_counts().items()}
        want = model.predict_batch(grd, sat, **kw)
        for g, w in zip(got, want, strict=True):
            if (g.row, g.col) != (w.row, w.col):
                raise AssertionError(f"mesh predict_batch {noise, fov}: {g.row, g.col} vs "
                                     f"{w.row, w.col}")
            worst["heatmap"] = max(worst["heatmap"], float(np.abs(g.heatmap - w.heatmap).max()))
            worst["heading"] = max(worst["heading"], abs(
                (g.orientation_deg - w.orientation_deg + 180) % 360 - 180))
    if worst["heatmap"] > MODEL_TOL["heatmap"] or worst["heading"] > HEADING_TOL_DEG:
        raise AssertionError(f"mesh predict_batch: {worst}")
    second = meshed.replicas[1]
    second._readout = lambda *a, **k: (_ for _ in ()).throw(
        AssertionError("a batch of one reached the second replica"))
    try:
        one = meshed.predict(grd[0], sat[0])
    finally:
        del second._readout
    ref = model.predict(grd[0], sat[0])
    if (one.row, one.col, one.probability) != (ref.row, ref.col, ref.probability):
        raise AssertionError(f"mesh batch of one {one} vs {ref}")

    pt = f"{tmp}/vigor_mesh.pt"
    model.save_torch(pt)
    rng = np.random.default_rng(72)
    pairs = [(rng.integers(0, 256, (*cfg.grd_hw, 3), dtype=np.uint8),
              rng.integers(0, 256, (*cfg.sat_hw, 3), dtype=np.uint8)) for _ in range(BATCH)]
    bodies = [json.dumps({"grd": _png_b64(g), "sat": _png_b64(s)}).encode() for g, s in pairs]
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
                        "--max_wait_ms", "20", "--mesh", "data"])
        except BaseException as e:  # noqa: BLE001 — reported to the phase
            failed.append(e)
            ready.set()

    serve.build_server = build_local
    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    clients = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        if not ready.wait(timeout=300) or failed:
            raise AssertionError(f"serve --mesh data did not start: {failed}")
        service, srv = started["service"], started["srv"]
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        MC.reset_launch_counts()
        answers = clients.submit(_client_load, url, bodies, BATCH).result()
        torch.cuda.synchronize()
        serve_launches = MC.launch_counts()
        want = model.predict_batch(np.stack([_prepare(g, cfg.grd_hw) for g, _ in pairs]),
                                   np.stack([_prepare(s, cfg.sat_hw) for _, s in pairs]))
        for (code, got), w in zip(answers, want):
            if code != 200 or (got["row"], got["col"]) != (w.row, w.col) or abs(
                    got["probability"] - w.probability) > SERVE_PROB_TOL:
                raise AssertionError(f"serve --mesh data: {code} {got} vs {w}")
        replicas = len(service.model.replicas)
    finally:
        clients.shutdown()
        serve.build_server = build
        if "srv" in started:
            started["srv"].shutdown()
            started["srv"].server_close()
        thread.join(timeout=60)
        if thread.is_alive():
            raise AssertionError("serve --mesh data did not stop")
    del meshed
    return {"mesh_predict_batch": {"replicas": 2, "heatmap_max_abs_err": worst["heatmap"],
                                   "heading_err_deg": worst["heading"],
                                   "launches_by_key": counts},
            "batch_of_one": "first replica",
            "serve_mesh_data": {"replicas": replicas, "requests": len(bodies),
                                "launches": serve_launches}}


def phase_parallel(dev: dict, model: api.CVMModel, cfg=None, device: str = "cuda",
                   rank_target=None, span: float = 200.0) -> dict:
    """Multi-device training and serving on the one card: (a) two spawned
    ranks over gloo, DDP / ZeRO-1 / grad_accum=2 at the global batch, (b)
    ``n_model=2`` (FSDP2) on the same ranks, each held to the one-process
    step; (c) one rank over NCCL against no process group, bit for bit;
    (d) serving from a two-replica mesh."""
    cfg = cfg or cvm.VIGOR
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_parallel_") as d:
        ref_info = _parallel_refs(cfg, d, device, span)
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()
        port = _free_port()
        _spawn(rank_target or _parallel_rank,
               [(r, PARALLEL_RANKS, port, d, cfg.name, device) for r in range(PARALLEL_RANKS)],
               timeout_s=400)
        ranks = []
        for r in range(PARALLEL_RANKS):
            with open(f"{d}/rank{r}.json") as f:
                ranks.append(json.load(f))
        if [(x["rank"], x["world"], x["backend"]) for x in ranks] != [
                (r, PARALLEL_RANKS, "gloo") for r in range(PARALLEL_RANKS)]:
            raise AssertionError(f"ranks {[(x['rank'], x['world']) for x in ranks]}")
        nccl = None
        if torch.device(device).type == "cuda":
            _spawn(_nccl_one_rank, [(_free_port(), d, cfg.name)], timeout_s=300)
            with open(f"{d}/nccl.json") as f:
                nccl = json.load(f)
            if (nccl["backend"], nccl["world"]) != ("nccl", 1):
                raise AssertionError(f"one-rank group: {nccl}")
        serving = _mesh_serving(model, d)
    info = {"phase": "parallel", "card": dev["nvidia_smi"], "preset": cfg.name,
            "global_batch": BATCH, "ranks": PARALLEL_RANKS, "label": GLOO_LABEL,
            "reference": ref_info,
            "by_rank": [x["cases"] for x in ranks], "nccl_one_rank": nccl,
            "serving": serving,
            "n_model": "run on one card: FSDP2 over gloo on CUDA tensors"}
    info["k1_launches"] = sum(c["launches"]["matching_epilogue"]
                              for x in ranks for c in x["cases"].values())
    keep = ("peak_gib", "launches_by_layout", "gradient_all_reduced_bytes_per_step",
            "bn_and_loss_all_reduced_bytes_per_step", "params_vs_ddp_worst_over_limit",
            "sharded_tensors")
    emit({**{k: v for k, v in info.items() if k != "by_rank"},
          "by_rank": [{name: {**{k: c[k] for k in keep if k in c},
                              "worst_gradient_err_over_limit":
                                  c["held"]["worst_gradient_err_over_limit"],
                              "bn_max_abs_err": c["held"]["bn_max_abs_err"]}
                       for name, c in x.items()} for x in info["by_rank"]]})
    return info


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


def _client_load(url: str, bodies: list, clients: int) -> list:
    """POST each body to ``url``/predict from ``clients`` threads: (status,
    answer) per request."""
    import concurrent.futures
    import urllib.error
    import urllib.request

    def post(body):
        req = urllib.request.Request(url + "/predict", data=body,
                                     headers={"Content-Type": "application/json"})
        try:
            with urllib.request.urlopen(req, timeout=120) as r:
                return r.status, json.loads(r.read())
        except urllib.error.HTTPError as e:
            return e.code, json.loads(e.read())

    with concurrent.futures.ThreadPoolExecutor(clients) as pool:
        return list(pool.map(post, bodies))


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
    413 and a 408."""
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
        answers = clients.submit(_client_load, url, bodies, SERVE_CLIENTS).result()
        torch.cuda.synchronize()
        launches = MC.launch_counts()
        disp = {k: b.dispatches - before[k][0] for k, b in service.batchers.items()}
        served = {k: b.items_served - before[k][1] for k, b in service.batchers.items()}
        metrics = service.metrics()
        codes = [c for c, _ in answers]
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
        stalled = _raw_status(port, b"POST /predict HTTP/1.1\r\nHost: x\r\n"
                                    b"Content-Length: 1000\r\n\r\n", b'{"grd": "')
        if (big, stalled) != (413, 408):
            raise AssertionError(f"serve: oversized body {big}, stalled body {stalled}")
        info.update({
            "server_metrics": metrics, "status_503": codes.count(503),
            "rejections": metrics["rejections"] - rejections0,
            "dispatches": {json.dumps(list(k)): v for k, v in disp.items()},
            "mean_batch_fill": sum(served.values()) / max(1, sum(disp.values())) / BATCH,
            "launches": {**launches, "matching_scores_prior": k2_prior,
                         "matching_scores_fov": k2_fov},
            "checked_against_plain": checked, "prob_max_abs_err": worst_prob,
            "heading_err_deg": worst_heading, "prob_tolerance": SERVE_PROB_TOL,
            "status_oversized": big, "status_stalled": stalled})
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


def _serve_int8(model: api.CVMModel, tmp: str) -> dict:
    """``python -m ccvpe_torch.serve --quantize int8 --calib_dir D`` through
    ``serve.main`` on 127.0.0.1, on the ``model`` phase's weights (written
    as a ``.pt``) at batch 8: 48 requests from 8 client threads (in a
    process of their own) over the three keys; every answer against the
    served int8 model's own ``predict_batch``; launches."""
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
    thread.start()
    clients = concurrent.futures.ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        if not ready.wait(timeout=300) or failed:
            raise AssertionError(f"serve --quantize int8 did not start: {failed}")
        service, srv = started["service"], started["srv"]
        qmodel = service.model
        n_int8 = sum(isinstance(m, TL.QuantConv2d) for m in qmodel.net.modules())
        url = f"http://127.0.0.1:{srv.server_address[1]}"
        for k in range(len(keys)):      # warm every key's batcher
            clients.submit(_client_load, url, [bodies[k]], 1).result()
        before = {k: b.dispatches for k, b in service.batchers.items()}
        MC.reset_launch_counts()
        TL.reset_int8_counts()
        answers = clients.submit(_client_load, url, bodies, QUANT_SERVE_CLIENTS).result()
        torch.cuda.synchronize()
        launches, int8 = MC.launch_counts(), TL.int8_counts()
        disp = {k: b.dispatches - before[k] for k, b in service.batchers.items()}
        codes = [c for c, _ in answers]
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
        return {"requests": n, "clients": QUANT_SERVE_CLIENTS,
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


def phase_quant(dev: dict, model: api.CVMModel) -> tuple[dict, api.CVMModel]:
    """int8 post-training quantization of the ``model`` phase's VIGOR model
    (a copy; batch 8, TF32 off): ``quantize_int8`` on a seeded batch;
    ``torch._int_mm``'s limits on this card; every int8 conv shape's sums
    against the plain version, exactly; ``predict_batch`` at the keys
    (180, 360), (36, 360) and (180, 180) through K1/K2 against the plain
    matching (the same pixel for every sample, the ``model`` phase's
    tolerances; K1/K2 launches and int8 products counted from 0); the int8
    readout's distance from the float32 model's (not gated); peak GiB;
    ``serve --quantize int8``'s answers.  Returns the phase's checks and
    the int8 model."""
    import copy

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model.cfg
    qmodel = api.CVMModel(cfg, copy.deepcopy(model.net), model.device)
    qmodel.quantize_int8([_images(cfg, 2, seed=50)])
    mods = [m for m in qmodel.net.modules() if isinstance(m, TL.QuantConv2d)]
    if any(m.weight.device != next(model.net.parameters()).device for m in mods):
        raise AssertionError("quantize_int8 left int8 convs off the model's device")
    info = {"phase": "quant", "card": dev["nvidia_smi"], "preset": cfg.name, "batch": BATCH,
            "calibration_pairs": 2, "int8_convs": len(mods),
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

    peak = {}
    for label, m in (("float32", model), ("int8", qmodel)):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        m.predict_batch(grd, sat)
        peak[label] = {"peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
                       "above_resident_gib": (torch.cuda.max_memory_allocated() - base) / 2 ** 30}
    info["peak"] = peak
    del plain
    gc.collect()
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_quant_") as tmp:
        info["serve"] = _serve_int8(model, tmp)
    emit(info)
    return info, qmodel


# visualize: one sample per setting through ``predict_sample`` on the card,
# kernels against the plain versions (``render`` draws with matplotlib,
# which the card's machine lacks: it is tested on the CPU)
VISUALIZE_SETTINGS = (("VIGOR", "vigor", ["--ori_noise", "180"]),
                      ("VIGOR", "vigor", ["--ori_noise", "36"]),
                      ("KITTI", "kitti", []), ("OxfordRobotCar", "oxford", []))


def phase_visualize(dev: dict, model: api.CVMModel, roots: dict) -> dict:
    """``python -m ccvpe_torch.visualize``'s forward (``predict_sample``) at
    full width on the seeded roots: VIGOR (the ``model`` phase's model) at
    ``--ori_noise 180`` (the shipped frozen orientations) and ``36``, one
    KITTI and one Oxford sample (seeded, BN-calibrated models); each through
    the kernels and again through the plain versions: the same
    ``loc_pred``/``loc_gt``, heatmap 1e-7, orientation 1e-3, the same GT;
    K1/K2 launches by kernel and layout, counted from 0 per setting."""
    from ccvpe_torch import visualize

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    nets = {"VIGOR": model.net}
    for preset in ("KITTI", "OxfordRobotCar"):
        m = api.load_model(preset=preset, seed=0)
        _calibrate(m, seed=1)
        nets[preset] = m.net
    results, launches = [], {}
    for dataset, root, extra in VISUALIZE_SETTINGS:
        argv = ["--dataset", dataset, "--dataset_root", roots[root], "--idx", "1", *extra]
        args = visualize.parse_args(argv)
        cfg = cvm.PRESETS[dataset]
        # the main path, every launch counter at 0 just before it
        MC.reset_launch_counts()
        got = visualize.predict_sample(dataset, args, cfg, nets[dataset], torch.device("cuda"))
        counts = MC.launch_counts()
        by_layout = {f"{k} {lay}": n for (k, lay), n in MC.launch_counts("layout").items() if n}
        n_k1 = sum(cg == cs for _, cs, cg, _ in preset_scales(cfg))
        prior = args.ori_noise < 180
        want = {"matching_epilogue": n_k1, "matching_scores": 6 - n_k1 + prior}
        if counts != want:
            raise AssertionError(f"visualize {dataset} {extra}: launches {counts}, want {want}")
        ref = visualize.predict_sample(dataset, visualize.parse_args([*argv, "--matching_impl",
                                                                      "plain"]),
                                       cfg, nets[dataset], torch.device("cuda"))
        sat_img, heatmap, ori, gt = got
        locs = [tuple(int(v) for v in np.unravel_index(a.argmax(), a.shape))
                for a in (heatmap, gt, ref[1], ref[3])]
        errs = {"heatmap": float(np.abs(heatmap - ref[1]).max()),
                "ori": float(np.abs(ori - ref[2]).max())}
        if (heatmap.shape != cfg.sat_hw or ori.shape != (*cfg.sat_hw, 2)
                or gt.shape != cfg.sat_hw or sat_img.shape != (*cfg.sat_hw, 3)):
            raise AssertionError(f"visualize {dataset}: shapes {sat_img.shape} {heatmap.shape} "
                                 f"{ori.shape} {gt.shape}")
        if not (np.isfinite(heatmap).all() and np.isfinite(ori).all()):
            raise AssertionError(f"visualize {dataset} {extra}: non-finite output")
        if (locs[0], locs[1]) != (locs[2], locs[3]) or not np.array_equal(gt, ref[3]):
            raise AssertionError(f"visualize {dataset} {extra}: loc_pred/loc_gt {locs[:2]} "
                                 f"against plain {locs[2:]}")
        for k, v in errs.items():
            if not v <= MODEL_TOL[k]:
                raise AssertionError(f"visualize {dataset} {extra}: {k} max abs err {v}")
        launches[f"{dataset} {' '.join(extra)}".strip()] = counts
        results.append({"dataset": dataset, "argv": extra, "loc_pred": locs[0],
                        "loc_gt": locs[1], "max_abs_err": errs, "launches": counts,
                        "launches_by_layout": by_layout})
    del nets
    gc.collect()
    torch.cuda.empty_cache()
    info = {"phase": "visualize", "card": dev["nvidia_smi"], "batch": 1, "dtype": "float32",
            "tolerance": {k: MODEL_TOL[k] for k in ("heatmap", "ori")},
            "render": "not run on the card (no matplotlib on its machine); tested on the CPU",
            "results": results, "launches": launches}
    emit(info)
    return info


def _same_poses(tag: str, got, want, exact: bool) -> dict:
    """``got`` against ``want`` pose by pose: exactly (row, col, heatmap,
    heading, probability), or at the ``model`` phase's gates."""
    hm = heading = 0.0
    for p, q in zip(got, want, strict=True):
        hm = max(hm, float(np.abs(p.heatmap - q.heatmap).max()))
        heading = max(heading, abs((p.orientation_deg - q.orientation_deg + 180) % 360 - 180))
        if (p.row, p.col) != (q.row, q.col) or not np.isfinite(p.orientation_deg):
            raise AssertionError(f"{tag}: pose {p} against {q}")
        if exact and (p.orientation_deg != q.orientation_deg
                      or p.probability != q.probability):
            raise AssertionError(f"{tag}: pose {p} against {q}")
    if (exact and hm) or hm > MODEL_TOL["heatmap"] or heading > HEADING_TOL_DEG:
        raise AssertionError(f"{tag}: heatmap {hm}, heading {heading} deg")
    return {"heatmap_max_abs_err": hm, "heading_err_deg": heading}


def phase_export(dev: dict, model: api.CVMModel, qmodel: api.CVMModel) -> dict:
    """``api.export_model`` of the ``model`` phase's VIGOR model on the card
    at batch 8 and at ``batch="dynamic"`` (served at 8 and 3), reloaded with
    ``load_exported``: each answer equals ``CVMModel(matching_impl="plain")
    .predict_batch`` exactly (row, col, heatmap, heading, probability) and
    the kernel path's at the ``model`` phase's gates; the ``quant`` phase's
    int8 model exported at batch 8 equals its own plain ``predict_batch``.
    The export traces the plain matching (no K1/K2 launch) by design."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = model.cfg
    info = {"phase": "export", "card": dev["nvidia_smi"], "preset": cfg.name,
            "dtype": "float32", "matching": "plain (the export traces no kernel launch)",
            "runs": {}}
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_export_") as tmp:
        for tag, m, batch, served in (("float32", model, BATCH, (BATCH,)),
                                      ("float32", model, "dynamic", (BATCH, 3)),
                                      ("int8", qmodel, BATCH, (BATCH,))):
            plain = api.CVMModel(cfg, m.net, m.device, matching_impl="plain")
            path = f"{tmp}/{tag}_{batch}"
            api.export_model(m, path, batch=batch)
            exported = api.load_exported(path)
            run = {"files": sorted(os.listdir(path)), "checks": {}}
            for b in served:
                grd, sat = _images(cfg, b, seed=70 + b)
                MC.reset_launch_counts()
                got = exported.predict_batch(grd, sat, return_heatmap=True)
                if sum(MC.launch_counts().values()):
                    raise AssertionError(f"the exported program launched {MC.launch_counts()}")
                name = f"{tag} batch={batch} served at {b}"
                run["checks"][b] = {
                    "vs_plain": _same_poses(name, got,
                                            plain.predict_batch(grd, sat, return_heatmap=True),
                                            exact=True),
                    "vs_kernel": _same_poses(name, got,
                                             m.predict_batch(grd, sat, return_heatmap=True),
                                             exact=False)}
            info["runs"][f"{tag} batch={batch}"] = run
            del exported, plain
            gc.collect()
            torch.cuda.empty_cache()
    emit(info)
    return info


BACKBONE_TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_torch_efficientnet.py's


def _tol_ratio(got: list, want: list) -> float:
    """The worst element of |got - want| / (atol + rtol |want|) at
    ``BACKBONE_TOL`` over matching tensors (at most 1: within the bar)."""
    return max((((a.double() - b.double()).abs()
                 / (BACKBONE_TOL["atol"] + BACKBONE_TOL["rtol"] * b.double().abs())).max().item())
               for a, b in zip(got, want, strict=True))


def phase_backbones(dev: dict) -> dict:
    """``EfficientNet("b1")`` ... ``("b7")``, each at its own resolution
    (``EFFICIENTNET_PARAMS``), batch 2, float32, TF32 off, seeded weights,
    BN statistics calibrated on that batch; the first sample's head features
    and block outputs against the same module on the CPU at batch 1.  The
    bar is ``BACKBONE_TOL`` against the CPU's float64 forward, widened to
    twice the CPU's own float32 distance from it where that is larger (B6's
    and B7's 45 and 55 blocks of float32 rounding reach the file's
    tolerance on the CPU itself); the distance from the CPU's float32 is
    printed beside it."""
    import copy

    from ccvpe_torch.nn import efficientnet as TE

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []
    for i, name in enumerate(f"b{k}" for k in range(1, 8)):
        res = TE.EFFICIENTNET_PARAMS[f"efficientnet-{name}"][2]
        net = TE.EfficientNet(name).to(memory_format=torch.channels_last)
        TL.init_uniform_(net, torch.Generator().manual_seed(100 + i))
        net = net.cuda()
        x = torch.randn(2, 3, res, res, generator=torch.Generator().manual_seed(200 + i))
        x = x.cuda().contiguous(memory_format=torch.channels_last)
        with torch.no_grad():
            calibrate_batch_norm_(net, lambda: net(x))
            feat, ms = net(x)
            got = [t[:1].cpu() for t in (feat, *ms)]
            cpu = copy.deepcopy(net).cpu()
            x1 = x[:1].cpu()
            f32, ms32 = cpu(x1)
            f64, ms64 = cpu.double()(x1.double())
        if not all(torch.isfinite(t).all() for t in got):
            raise AssertionError(f"{name}: non-finite output")
        cpu_ratio = _tol_ratio([f32, *ms32], [f64, *ms64])
        bar = max(1.0, 2 * cpu_ratio)
        card_ratio = _tol_ratio(got, [f64, *ms64])
        if not card_ratio <= bar:
            raise AssertionError(f"{name}: the card is {card_ratio} x BACKBONE_TOL from the CPU's "
                                 f"float64 forward, over its bar {bar}")
        del cpu
        rows.append({"backbone": name, "resolution": res, "blocks": len(net._blocks),
                     "params": sum(p.numel() for p in net.parameters()),
                     "head": list(feat.shape),
                     "max_abs_err_vs_cpu_f32": max((a - b).abs().max().item()
                                                   for a, b in zip(got, [f32, *ms32])),
                     "tol_ratio_vs_cpu_f32": _tol_ratio(got, [f32, *ms32]),
                     "tol_ratio_vs_cpu_f64": card_ratio, "cpu_f32_tol_ratio_vs_f64": cpu_ratio,
                     "bar": bar})
        del net, x, feat, ms
        gc.collect()
        torch.cuda.empty_cache()
    info = {"phase": "backbones", "card": dev["nvidia_smi"], "batch": 2, "dtype": "float32",
            "tolerance": BACKBONE_TOL, "rows": rows}
    emit(info)
    return info


def kernels_line(kern: dict, model: dict, presets: dict, train: dict, data: dict, cli: dict,
                 options: dict | None = None, serve: dict | None = None,
                 quant: dict | None = None, parallel: dict | None = None,
                 visual: dict | None = None, conv: dict | None = None) -> list[dict]:
    """The rows of the ``kernels`` line: each kernel's largest error at its
    checked shapes (phase ``kernels``, ``model_presets``, ``conv``) and its
    launches on each main path, each counted from 0 just before that path
    ran."""
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
    # the KITTI and Oxford forwards: each kernel's row lists its layouts at
    # the preset's shapes (one all-bin forward) and counts its launches over
    # the preset's settings; the error is the model's stacks, kernel vs plain
    for preset, p in presets["presets"].items():
        stacks = max(r["max_abs_err"]["stacks"] for r in p["results"])
        for kernel, name, replaces in (("K1", "matching_epilogue", K1_REPLACES),
                                       ("K2", "matching_scores", K2_REPLACES)):
            rows = [r for r in p["shapes"] if r["kernel"] == kernel]
            if not rows:
                continue
            row = _summary(f"{name} ({kernel}), {preset}", rows, replaces)
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
    # the parallel phase: both ranks' train steps (K1), the mesh model at
    # the serve keys and ``serve --mesh data``
    if parallel is not None:
        srv = parallel["serving"]
        by_key = srv["mesh_predict_batch"]["launches_by_key"]
        keys = [json.dumps(list(k)) for k in SERVE_KEYS]
        summary[0]["launches_by_path"]["parallel_train"] = parallel["k1_launches"]
        summary[0]["launches_by_path"]["parallel_serve"] = (
            sum(by_key[k]["matching_epilogue"] for k in keys)
            + srv["serve_mesh_data"]["launches"]["matching_epilogue"])
        summary[1]["launches_by_path"]["parallel_serve"] = (
            by_key[keys[1]]["matching_scores"] - by_key[keys[0]]["matching_scores"])
        summary[2]["launches_by_path"]["parallel_serve"] = by_key[keys[2]]["matching_scores"]
        for row in summary[:3]:
            row["launches"] = sum(row["launches_by_path"].values())
    # the visualizer's forwards: VIGOR's K1 at both settings and K2 (the
    # prior's bottleneck stack), and each KITTI and Oxford kernel's row
    if visual is not None:
        rows = {row["name"]: row for row in summary}
        for setting, counts in visual["launches"].items():
            preset = setting.split()[0]
            for kernel, name in (("K1", "matching_epilogue"), ("K2", "matching_scores")):
                if not counts[name]:
                    continue
                if preset == "VIGOR":
                    row = summary[0] if kernel == "K1" else summary[1]
                else:
                    row = rows[f"{name} ({kernel}), {preset}"]
                by_path = row["launches_by_path"]
                by_path["visualize"] = by_path.get("visualize", 0) + counts[name]
        for row in summary:
            row["launches"] = sum(row["launches_by_path"].values())
    # the decoders' 3x3 convs: their checks over a call's 24 shapes (phase
    # ``conv``; the backward's dgrad and wgrad beside them), launches counted
    # on each predict_batch; a train step's by pass (phase ``train``)
    if conv is not None:
        oxford = sum(r["conv_launches"] for r in presets["presets"]["OxfordRobotCar"]["results"])
        paths = {"VIGOR": {"predict_batch": sum(model["conv_launches_per_setting"]),
                           "predict_batch_OxfordRobotCar": oxford},
                 "KITTI": {"predict_batch_KITTI": sum(
                     r["conv_launches"] for r in presets["presets"]["KITTI"]["results"])}}
        for preset, by_path in paths.items():
            c = conv["presets"][preset]
            summary.append({
                "name": f"conv3x3 (decoder 3x3 convs), {preset}", "route": "cuda",
                "source": CONV_SOURCE, "replaces": CONV_REPLACES, "dtype": "float32",
                "max_rel_err": c["max_rel_err"],
                "max_backward_rel_err": c["max_backward_rel_err"],
                "checked_at": f"the 24 decoder convs of a batch-{BATCH} call",
                "plans": [r["launch"]["plan"] for r in c["rows"]],
                "launches_by_path": by_path, "launches": sum(by_path.values()),
                "launches_train_step": train["conv_launches_per_step"]})
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
                    help="also write the ptxas report and every check of the run here")
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
    kern = phase_kernels()
    conv = phase_conv(dev)
    model, net = phase_model()
    presets = phase_model_presets(dev)
    train = phase_train(dev)
    options = phase_train_options(dev)
    with tempfile.TemporaryDirectory(prefix="ccvpe_smoke_roots_") as tmp:
        roots = write_roots(tmp)
        data = phase_data(dev, roots)
        cli = phase_cli(dev, roots)
        visual = phase_visualize(dev, net, roots)
    parallel = phase_parallel(dev, net)
    serve = phase_serve(dev, net)
    quant, qmodel = phase_quant(dev, net)
    export = phase_export(dev, net, qmodel)
    del qmodel
    backbones = phase_backbones(dev)
    summary = kernels_line(kern, model, presets, train, data, cli, options, serve, quant,
                           parallel, visual, conv)
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"device": dev, "kernels": {k: v for k, v in kern.items() if k != "max_err"},
             "conv": conv, "model": model, "model_presets": presets, "train": train,
             "train_options": options, "data": data, "cli": cli, "serve": serve,
             "quant": quant, "parallel": parallel, "visualize": visual, "export": export,
             "backbones": backbones,
             "seconds": time.perf_counter() - t0}, indent=1))
    emit({"kernels": summary})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
