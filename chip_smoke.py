#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``ccvpe_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--out DIR]

Phases, each printing one JSON line:

1. device:  the card's name and power limit (``nvidia-smi``), torch and CUDA.
2. build:   ``nvcc`` builds the matching kernels from ``ccvpe_torch/csrc``.
3. kernels: each kernel against its plain PyTorch version on the card, at
   the VIGOR shapes (batch 8), the ori-prior bottleneck, the Oxford and KITTI
   masked windows and two ragged maps, in float32 and bfloat16; then times of
   the kernel, the plain version and ``torch.bmm`` (a yardstick only) beside
   the least time the card could take.
4. model:   ``ccvpe_torch.api.load_model(preset="VIGOR", seed=0)`` on the
   card; ``predict_batch`` at batch 8 with ``ori_noise`` 180 and 36 and with
   ``fov=180``, counting kernel launches, held against the same model with
   matching forced to the plain versions; and a NANO model on the card held
   against the same model on the CPU.
5. timing:  steady-state ``predict_batch`` pairs/s at batch 8 in float32,
   and the device time by kernel of three calls (``torch.profiler``).

Then the ``kernels`` summary line, the raw ``nvidia-smi`` line and, last,
``{"ok": true, "device": {...}}``.  Any failure raises: the script then exits
non-zero and prints no result line.  It needs one CUDA device and ``nvcc``.

``--out DIR`` also writes the ptxas report, every number of the run and the
profiler's table and trace to ``DIR``.
"""

from __future__ import annotations

import argparse
import json
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
from ccvpe_torch.nn.layers import calibrate_batch_norm_
from ccvpe_torch.data.transforms import normalize_images
from ccvpe_torch.ops import _build
from ccvpe_torch.ops import matching as TM
from ccvpe_torch.ops import matching_cuda as MC

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
        xf, gf = x.float(), g.float()
        if kernel == "K1":
            want = TM.matching_epilogue_plain(xf, gf, shift, offsets, window)
        else:
            want = (TM.matching_scores_plain(xf, gf, shift, offsets, window),)
        layouts = ["warp"] + (["row"] if MC.row_layout_fits(cs, cg, len(offsets)) else [])
        for layout in layouts:
            if kernel == "K1":
                got = MC.launch_matching_epilogue(x, g, shift, offsets, window, layout)
            else:
                got = (MC.launch_matching_scores(x, g, shift, offsets, window, layout),)
            torch.cuda.synchronize()
            name = (f"{kernel} {layout} x{[b, *hw, cs]} g{[b, cg]} shift {shift} offsets "
                    f"{offsets[0]}..{offsets[-1]} {window} {str(dtype)[6:]}")
            err = _check(name, got, want, dtype)
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
        for kernel in ("K1", "K2"):
            run(kernel, 2, (41, 41), 1280, 1280, 64, range(20), "first", dtype, 13)
            run(kernel, 2, (66, 66), 320, 320, 16, range(20), "first", dtype, 14)
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
        layout = MC.pick_layout(x, cg, len(offsets))
        by_layout = {lay: device_ms(lambda lay=lay: k_fn(lay)) for lay in ("warp", "row")
                     if lay == "warp" or MC.row_layout_fits(cs, cg, len(offsets))}
        row = {"kernel": kernel, "x": [BATCH, *hw, cs], "g": [BATCH, cg], "bins": 20,
               "layout": layout, "ms": by_layout[layout], "ms_by_layout": by_layout,
               "eager_ms": time_ms(k_fn), "plain_ms": device_ms(p_fn),
               "library_ms": device_ms(lambda: torch.bmm(x3, banded)),
               "bound_ms": bound, "bound_by": by, "bytes": nbytes, "flops": flops}
        row["achieved_bytes_per_s"] = nbytes / (row["ms"] * 1e-3)
        shapes.append(row)
        return row

    k1 = [timed("K1", (s, s), cs, cs, shift, 20 + i)
          for i, (s, cs, shift) in enumerate(VIGOR_SCALES)]
    k2 = [timed("K2", (8, 8), 1280, 1280, 64, 30)]
    # the limited-fov setting: K2 with the masked window at every scale
    for i, (s, cs, shift) in enumerate(VIGOR_SCALES):
        timed("K2", (s, s), cs, cs // 2, shift, 40 + i)
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
                "timed_at": "sum over x " + ", ".join(str(r["x"]) for r in rows)}

    return {"checks": checks, "shapes": shapes,
            "summary": [summary("matching_epilogue (K1)", k1, "K1", K1_REPLACES),
                        summary("matching_scores (K2)", k2, "K2", K2_REPLACES)]}


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

    # the main path, with every launch counter at 0 just before it
    MC.reset_launch_counts()
    poses, seen = [], []
    for kw, _ in settings:
        poses.append(model.predict_batch(grd, sat, return_heatmap=True, **kw))
        seen.append((MC.LAUNCHES["matching_epilogue"], MC.LAUNCHES["matching_scores"]))
    launches = dict(MC.LAUNCHES)
    steps = [(a[0] - b[0], a[1] - b[1]) for a, b in zip(seen, [(0, 0)] + seen)]
    if steps != [w for _, w in settings]:
        raise AssertionError(f"kernel launches (K1, K2) per setting {steps}, "
                             f"want {[w for _, w in settings]}")

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
    try:    # a diagnostic, not a check: a failing profiler fails no phase
        res["profile"] = _profile(model, grd, sat, out)
    except Exception as e:  # noqa: BLE001
        res["profile"] = {"error": repr(e)}
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
    mine = [r for r in rows if "match_row_kernel" in r[0] or "match_warp_kernel" in r[0]]
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
    timing = phase_timing(dev, net, args.out)
    summary = kern["summary"]
    for row, key in zip(summary, ("matching_epilogue", "matching_scores")):
        row["launches"] = model["launches"][key]
    if args.out is not None:
        (args.out / "chip_smoke.json").write_text(json.dumps(
            {"device": dev, "kernels": kern, "model": model, "timing": timing,
             "seconds": time.perf_counter() - t0}, indent=1))
    emit({"kernels": summary})
    print(dev["nvidia_smi"], flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    signal.alarm(0)
    return 0


if __name__ == "__main__":
    sys.exit(main())
