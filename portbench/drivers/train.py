"""Training: the step of ``train.loop.make_train_step`` as the trainer runs
it, fed by ``data.transforms.assemble_device_batch`` from a pool of seeded
raw batches resident on the card.

Traffic parameters: ``batch``, ``pool`` (raw batches: uint8 images at model
size, camera offsets within +-``span`` px, headings in [0, 360)), ``lr``,
``weight_info_nce``, ``weight_ori``, ``checked_steps`` (the first steps,
which the reference follows), ``warmup`` (further steps before the window),
``trace_steps`` and ``trace_full_steps`` (the steps of the two traced
slices that a ``--trace 1`` run adds after its window, ``lib.trace``).

Set-up builds one train state and drives it through the checked steps with
the window's own call and feed, on distinct rows; the same state then runs
the window.  ``train_samples_per_s``: the samples of the steps finished by
the closing ``torch.cuda.synchronize()``, over the time from the window's
start to that synchronisation.

Compared with the reference's three steps from the same weights, rows and
drop-connect draws: the first step's loss (every step's gap is printed
beside the result); the first gradient, read from Adam's first moment
after step one; the change of the parameters over the three steps, read
after step three.  The gradient and the change are compared by
the gap of each leaf's norm, over the larger of the reference's norm of
that leaf and of the median leaf; the change leaves out leaves whose
reference gradient is under a thousandth of the median leaf's (they move
by round-off alone under Adam).
"""

from __future__ import annotations

import gc
import math
import statistics
import itertools
import time

import torch
from torch.profiler import record_function

from ..lib import harness, program, trace as trace_lib, weights
from ..reference import cvm as ref
from ..reference import train as ref_train

FEED_RANGE = "portbench.feed"
NEGLIGIBLE_GRAD = 1e-3


def _pool(arch, tr, seed: int, device) -> list[dict]:
    gen = torch.Generator(device=device)
    gen.manual_seed(weights.sub_seed(seed, "inputs"))
    b, out = tr["batch"], []
    for _ in range(tr["pool"]):
        grd = torch.randint(0, 256, (b, *arch.grd_hw, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        sat = torch.randint(0, 256, (b, *arch.sat_hw, 3), generator=gen, device=device,
                            dtype=torch.uint8)
        off = (torch.rand((2, b), generator=gen, device=device) * 2 - 1) * tr["span"]
        angle = torch.rand((b,), generator=gen, device=device) * 360
        out.append({"grd": grd, "sat": sat, "row_offset": off[0], "col_offset": off[1],
                    "angle": angle})
    return out


def run(ctx: harness.Context) -> harness.Outcome:
    from ccvpe_torch.data.transforms import assemble_device_batch
    from ccvpe_torch.train import loop

    cfg_file, tr = ctx.cell.config, ctx.cell.workload["params"]
    arch = ref.arch_from(cfg_file)
    cfg = program.preset(cfg_file, arch)
    dev = ctx.device
    harness.set_precision(harness.REFERENCE_PRECISION)
    sd = weights.make_state_dict(arch, ctx.seed, dev)
    prec = ctx.precision
    if prec["quantize"] is not None:
        raise SystemExit("the train step has no quantized path")
    harness.set_precision(prec)
    state = loop.train_state_from_torch({k: v.clone() for k, v in sd.items()}, cfg,
                                        device=dev, learning_rate=tr["lr"],
                                        param_dtype=prec["param_dtype"])
    step = loop.make_train_step(cfg, weight_info_nce=tr["weight_info_nce"],
                                weight_ori=tr["weight_ori"],
                                compute_dtype=prec["compute_dtype"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(weights.sub_seed(ctx.seed, "drop_connect"))
    pool = _pool(arch, tr, ctx.seed, dev)

    def feed(i):
        with record_function(FEED_RANGE):
            return assemble_device_batch(pool[i % len(pool)], sat_hw=arch.sat_hw,
                                         bins=arch.bins, clockwise=False, device=dev)

    params = dict(state.model.named_parameters())
    losses, g1 = [], {}
    for i in range(tr["checked_steps"]):
        losses.append(step(state, feed(i), gen)["loss"])
        if i == 0:
            beta1 = state.optimizer.param_groups[0]["betas"][0]
            g1 = {k: state.optimizer.state[p]["exp_avg"] / (1 - beta1)
                  for k, p in params.items() if p in state.optimizer.state}
            g1 = {k: float(v.norm()) for k, v in g1.items()}
    change = {k: float((p.detach() - sd[k]).norm()) for k, p in params.items()}
    losses = [float(v) for v in losses]
    k = tr["checked_steps"]
    for _ in range(tr["warmup"]):
        step(state, feed(k), gen)
        k += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    setup_s = harness.setup_done(ctx)

    n = 0
    t0 = time.perf_counter()
    ends = []
    while time.perf_counter() - t0 < ctx.seconds:
        step(state, feed(k + n), gen)
        ends.append(time.perf_counter())
        n += 1
    if dev.type == "cuda":
        torch.cuda.synchronize()
    t1 = time.perf_counter()
    samples = n * tr["batch"]
    readings = {"batch": tr["batch"], "samples_per_s": samples / (t1 - t0),
                **harness.iteration_times(t0, ends[:-1] + [t1])}
    trace = None
    if ctx.trace:
        steps = itertools.count(k + n)
        trace = trace_lib.traced(lambda: step(state, feed(next(steps)), gen),
                                 tr["trace_steps"], tr["trace_full_steps"])
    memory = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    del state, step, params
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    checks, detail = _check(sd, arch, pool, tr, ctx, losses, g1, change)
    e2e = {"train_samples_per_s": readings["samples_per_s"], "setup_s": setup_s}
    return harness.Outcome(e2e, samples, 0, checks, memory, trace, readings, {"train": detail})


def _worst(values) -> float:
    """The largest of ``values``; infinite if any is not finite."""
    values = list(values)
    return max(values) if all(math.isfinite(v) for v in values) else math.inf


def _check(sd, arch, pool, tr, ctx, losses, g1, change) -> dict:
    harness.set_precision(harness.REFERENCE_PRECISION)
    dev = ctx.device
    trainable = [k for k in sd if sd[k].is_floating_point() and "running_" not in k
                 and "._fc." not in k]
    p = {k: v.clone() for k, v in sd.items()}
    for k in trainable:
        p[k].requires_grad_(True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(weights.sub_seed(ctx.seed, "drop_connect"))
    h, w = arch.sat_hw
    adam: dict = {}
    ref_losses, ref_g1 = [], {}
    for t in range(tr["checked_steps"]):
        raw = pool[t]
        gauss, wts, ori = ref_train.ground_truth(raw["row_offset"], raw["col_offset"],
                                                 raw["angle"], h, w, arch.bins)
        out = ref.forward(p, arch, ref.normalize(raw["grd"]), ref.normalize(raw["sat"]),
                          mode=ref.Mode("train", gen))
        loss = ref_train.total_loss(out, gauss, wts, ori, tr["weight_info_nce"],
                                    tr["weight_ori"])[0]
        grads = dict(zip(trainable, torch.autograd.grad(loss, [p[k] for k in trainable])))
        del out
        ref_losses.append(float(loss.detach()))
        if t == 0:
            ref_g1 = {k: float(g.norm()) for k, g in grads.items()}
        ref_train.adam_step(p, grads, adam, t + 1, tr["lr"])
        del grads, loss
    ref_change = {k: float((p[k].detach() - sd[k]).norm()) for k in trainable}
    limits = ctx.cell.workload["checks"]
    by_step = [abs(a - b) / abs(b) for a, b in zip(losses, ref_losses)]
    med_g = statistics.median(ref_g1.values())
    grad = {k: abs(g1.get(k, 0.0) - ref_g1[k]) / max(ref_g1[k], med_g) for k in trainable}
    moved = [k for k in trainable if ref_g1[k] >= NEGLIGIBLE_GRAD * med_g]
    med_c = statistics.median(ref_change[k] for k in moved)
    change = {k: abs(change[k] - ref_change[k]) / max(ref_change[k], med_c) for k in moved}
    detail = {"loss_rel_by_step": by_step, "left_out_of_change": len(trainable) - len(moved),
              "worst_grad_leaf": max(grad, key=grad.get),
              "worst_change_leaf": max(change, key=change.get)}
    # the first step's loss: the later steps' losses carry Adam's sign-like
    # update of gradients that round-off alone sets (PERF.md section 2)
    return {"loss_rel": (_worst(by_step[:1]), limits["loss_rel"]),
            "grad_norm_gap": (_worst(grad.values()), limits["grad_norm_gap"]),
            "change_norm_gap": (_worst(change.values()), limits["change_norm_gap"])}, detail
