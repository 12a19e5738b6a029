"""Offline localization: a closed loop of ``api.CVMModel.predict_batch``.

Traffic parameters (``portbench/workloads/<cell>.json``): ``batch``,
``pool`` (seeded uint8 batches at model size on the host, used in turn),
``ori_noise``, ``fov``, ``warmup`` (calls before the window),
``trace_calls`` and ``trace_full_calls`` (the calls of the two traced
slices that a ``--trace 1`` run adds after its window, ``lib.trace``).

``pairs_per_s``: pairs whose poses reached the host inside the window,
over the window.  After the window every answer is held against the plain
reference's forward of its batch, on the same weights and images.
"""

from __future__ import annotations

import itertools
import time

import numpy as np
import torch

from ..lib import harness, images, program, trace as trace_lib, weights
from ..reference import cvm as ref


def run(ctx: harness.Context) -> harness.Outcome:
    cfg_file, tr = ctx.cell.config, ctx.cell.workload["params"]
    arch = ref.arch_from(cfg_file)
    cfg = program.preset(cfg_file, arch)
    harness.set_precision(harness.REFERENCE_PRECISION)
    sd = weights.make_state_dict(arch, ctx.seed, ctx.device)
    harness.set_precision(ctx.precision)
    model = program.serving_model(cfg, sd, ctx.device, ctx.precision, tr["ori_noise"])
    rng = np.random.default_rng(weights.sub_seed(ctx.seed, "inputs"))
    pool = images.uniform_batches(rng, tr["pool"], tr["batch"], arch.grd_hw, arch.sat_hw)
    kw = dict(ori_noise=tr["ori_noise"], fov=tr["fov"], return_heatmap=False)
    for i in range(tr["warmup"]):
        model.predict_batch(*pool[i % len(pool)], **kw)
    setup_s = harness.setup_done(ctx)

    answers = []
    t0 = time.perf_counter()
    ends = []
    i = 0
    while True:
        poses = model.predict_batch(*pool[i % len(pool)], **kw)
        ends.append(time.perf_counter())
        if ends[-1] - t0 > ctx.seconds:
            break
        answers.append((i % len(pool), poses))
        i += 1
    pairs = sum(len(p) for _, p in answers)
    readings = {"batch": tr["batch"], "pairs_per_s": pairs / ctx.seconds,
                **harness.iteration_times(t0, ends)}
    trace = None
    if ctx.trace:
        calls = itertools.count(i)
        trace = trace_lib.traced(
            lambda: model.predict_batch(*pool[next(calls) % len(pool)], **kw),
            tr["trace_calls"], tr["trace_full_calls"])
    memory = torch.cuda.max_memory_allocated(ctx.device) if ctx.device.type == "cuda" else 0
    del model
    checks = _check(sd, arch, pool, answers, tr, ctx.device, ctx.cell.workload["checks"])
    e2e = {"pairs_per_s": readings["pairs_per_s"], "setup_s": setup_s}
    return harness.Outcome(e2e, pairs, 0, checks, memory, trace, readings)


@torch.no_grad()
def _check(sd, arch, pool, answers, tr, device, limits) -> dict:
    """The program's answers against the reference's, batch by batch."""
    if device.type == "cuda":
        torch.cuda.empty_cache()
    harness.set_precision(harness.REFERENCE_PRECISION)
    offsets = program.loc_offsets(tr["ori_noise"])
    got, want = [], []
    for j, (grd, sat) in enumerate(pool):
        mine = [poses for k, poses in answers if k == j]
        if not mine:
            continue
        if tr["fov"] < 360:
            grd = grd[:, :, :int(grd.shape[2] * tr["fov"] / 360)]
        g = ref.normalize(torch.from_numpy(grd).to(device))
        s = ref.normalize(torch.from_numpy(sat).to(device))
        out = ref.forward(sd, arch, g, s, loc_offsets=offsets,
                          circular=arch.circular and tr["fov"] >= 360)
        picks = [(b, p.row, p.col) for poses in mine for b, p in enumerate(poses)]
        want += program.reference_at(out, picks)
        got += [(p.probability, p.orientation_deg) for poses in mine for p in poses]
    if not got:
        return {"prob_rel": (float("inf"), limits["prob_rel"])}
    prob, ori = program.pose_gaps(got, want)
    return {"prob_rel": (prob, limits["prob_rel"]), "ori_gap": (ori, limits["ori_gap"])}
