"""Offline localization under a heading prior: ``infer``'s closed loop of
``api.CVMModel.predict_batch`` and its two checks, and a third on the
full-bin bottleneck stack.

Where the prior narrows the localization branch's bins, the bottleneck
computes a second matching stack over every bin, which only the orientation
decoder reads.  On seeded weights the orientation field hardly depends on
it (the decoder's skip maps dominate the field), so ``ori_gap`` cannot tell
that stack from another.  ``stack_rel`` can: after the window each pooled
batch runs once more through the timed model, and the stack its call wrote
(the captured graphs' own tensor where ``predict_batch`` replays CUDA
graphs, the eager forward's elsewhere) is held against the reference's,
max |gap| over max |reference|, the widest batch.

Traffic parameters: ``infer``'s.  Where the configuration names the
model's ``variant`` (its evaluation ``fov`` and ``ori_noise``), the
traffic has to give the same two.
"""

from __future__ import annotations

import itertools
import math
import time

import numpy as np
import torch

from ..lib import harness, images, program, trace as trace_lib, weights
from ..reference import cvm as ref
from . import infer


def run(ctx: harness.Context) -> harness.Outcome:
    cfg_file, tr = ctx.cell.config, ctx.cell.workload["params"]
    variant = cfg_file.get("variant")
    if variant and (variant["fov"], variant["ori_noise"]) != (tr["fov"], tr["ori_noise"]):
        raise SystemExit(f"{cfg_file['name']} evaluates at fov {variant['fov']}, ori_noise "
                         f"{variant['ori_noise']}; the traffic gives {tr['fov']}, {tr['ori_noise']}")
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
    stacks = [_bottleneck_stack(model, grd, sat, kw) for grd, sat in pool]
    del model
    limits = ctx.cell.workload["checks"]
    checks = infer._check(sd, arch, pool, answers, tr, ctx.device, limits)
    checks["stack_rel"] = (_stack_gap(sd, arch, pool, stacks, tr, ctx.device),
                           limits["stack_rel"])
    e2e = {"pairs_per_s": readings["pairs_per_s"], "setup_s": setup_s}
    return harness.Outcome(e2e, pairs, 0, checks, memory, trace, readings)


def _bottleneck_stack(model, grd, sat, kw) -> torch.Tensor:
    """The full-bin bottleneck stack [B, h, w, bins] of one call of the
    timed model on these images, on the host."""
    if not model.uses_graphs():
        out, _ = model.forward_readout(grd, sat, ori_noise=kw["ori_noise"], fov=kw["fov"])
        return out.matching_scores[0].float().cpu()
    model.predict_batch(grd, sat, **kw)
    graphed = next(reversed(model.graphs.values()))      # the call's own graphs
    loc = next(h for h in graphed.held if hasattr(h, "stacks"))
    return loc.stacks[0].float().cpu()


@torch.no_grad()
def _stack_gap(sd, arch, pool, stacks, tr, device) -> float:
    """The widest batch's max |program - reference| over max |reference|
    of the full-bin bottleneck stack."""
    harness.set_precision(harness.REFERENCE_PRECISION)
    offsets = program.loc_offsets(tr["ori_noise"])
    gap = 0.0
    for (grd, sat), got in zip(pool, stacks):
        if tr["fov"] < 360:
            grd = grd[:, :, :int(grd.shape[2] * tr["fov"] / 360)]
        g = ref.normalize(torch.from_numpy(grd).to(device))
        s = ref.normalize(torch.from_numpy(sat).to(device))
        want = ref.forward(sd, arch, g, s, loc_offsets=offsets,
                           circular=arch.circular and tr["fov"] >= 360).scores[0].cpu()
        if got.shape != want.shape:
            return float("inf")
        rel = float((got - want).abs().max() / want.abs().max())
        if not math.isfinite(rel):
            return float("inf")
        gap = max(gap, rel)
    return gap
