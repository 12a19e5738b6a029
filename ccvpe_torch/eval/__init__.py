"""The BASELINE eval runner of the port (counterpart of ``ccvpe_tpu/eval``):
every BASELINE.json eval configuration in one command, one JSON report.

    python -m ccvpe_torch.eval --configs all \\
        --vigor_root ... --kitti_root ... --oxford_root ... \\
        --vigor_samearea_model m1.pt --vigor_crossarea_model m2.pt \\
        --kitti_model m3.pt --oxford_model m4.pt --out report.json

Each configuration runs the eval path of the port's CLI for its dataset
(``ccvpe_torch.train_VIGOR``, ``train_KITTI``, ``train_OxfordRobotCar``)
in this process, with the flags of the reference's protocols, so the
report holds what those entry points measure.  A configuration that fails
is recorded and the others still run.  Under ``torchrun`` every rank runs
every configuration and rank 0 writes the report.
"""

from __future__ import annotations

import importlib
import json
import time


def _missing(path: str) -> str:
    # the CLIs evaluate seeded random weights when the model file does not
    # exist (smoke/synthetic runs); route "" through that path
    return path or "/nonexistent/model-not-provided"


def build_configs(args) -> list[dict]:
    """The five BASELINE.json configs as (id, name, CLI module, argv)."""
    common = ["--num_workers", str(args.num_workers), "--results_dir", args.results_dir]
    if args.steps:
        common += ["--steps_per_epoch", str(args.steps)]
    preset = ["--model_preset", args.model_preset] if args.model_preset else []
    cfgs = [
        {
            "id": 1,
            "name": "VIGOR samearea single-pair inference, known orientation (ori_noise 0)",
            "module": "ccvpe_torch.train_VIGOR",
            "argv": ["--training", "False", "--area", "samearea", "--ori_noise", "0", "-b", "1",
                     "--dataset_root", args.vigor_root,
                     "--test_model_path", _missing(args.vigor_samearea_model)] + preset + common,
        },
        {
            "id": 2,
            "name": "VIGOR samearea full test set, no orientation prior (ori_noise 180), batched",
            "module": "ccvpe_torch.train_VIGOR",
            "argv": ["--training", "False", "--area", "samearea", "--ori_noise", "180",
                     "-b", str(args.batch_size), "--dataset_root", args.vigor_root,
                     "--test_model_path", _missing(args.vigor_samearea_model),
                     "--orientation_dir", args.orientation_dir] + preset + common,
        },
        {
            "id": 3,
            "name": "VIGOR crossarea + limited HFoV (180/108) eval",
            "module": "ccvpe_torch.train_VIGOR",
            "sub": [["--training", "False", "--area", "crossarea", "--ori_noise", "180",
                     "--FoV", str(fov), "-b", str(args.batch_size),
                     "--dataset_root", args.vigor_root,
                     "--test_model_path", _missing(args.vigor_crossarea_model),
                     "--orientation_dir", args.orientation_dir] + preset + common
                    for fov in (180, 108)],
            "sub_names": ["FoV180", "FoV108"],
        },
        {
            "id": 4,
            "name": "KITTI eval with [-10, +10] deg orientation prior (rotation_range 10)",
            "module": "ccvpe_torch.train_KITTI",
            "argv": ["--training", "False", "--rotation_range", "10",
                     "-b", str(args.batch_size), "--dataset_root", args.kitti_root,
                     "--test_model_path", _missing(args.kitti_model)] + preset + common,
        },
        {
            "id": 5,
            "name": "Oxford RobotCar sequential per-frame pose (3 streaming traversals)",
            "module": "ccvpe_torch.train_OxfordRobotCar",
            "argv": ["--training", "False", "-b", str(args.batch_size),
                     "--grd_image_root", args.oxford_root,
                     "--test_model_path", _missing(args.oxford_model)] + preset + common,
        },
    ]
    if args.configs != "all":
        wanted = {int(x) for x in args.configs.split(",")}
        cfgs = [c for c in cfgs if c["id"] in wanted]
    return cfgs


def run_config(cfg: dict) -> dict:
    """Run one config's CLI ``main``; a failure is recorded, not raised.

    Each CLI ``main`` ends at ``parallel.mesh.finalize_run``, a counted
    barrier of every rank.  A rank whose run failed before reaching it
    catches up on its count here, so the ranks stay in step for the
    configurations after it."""
    from ..parallel import mesh

    mod = importlib.import_module(cfg["module"])
    expect = mesh.finalize_count() + (len(cfg["sub"]) if "sub" in cfg else 1)
    t0 = time.time()
    try:
        if "sub" in cfg:
            metrics = {name: mod.main(argv) for name, argv in zip(cfg["sub_names"], cfg["sub"])}
        else:
            metrics = mod.main(cfg["argv"])
        status = "ok"
    except SystemExit as e:  # a missing fixture or dataset
        metrics, status = {"error": str(e)}, "failed"
    except Exception as e:  # noqa: BLE001 -- recorded so the other configs still run
        metrics, status = {"error": f"{type(e).__name__}: {e}"}, "failed"
    while mesh.finalize_count() < expect:
        try:
            mesh.finalize_run()
        except Exception:  # noqa: BLE001 -- the barrier timed out: peers died; keep reporting
            break
    return {"id": cfg["id"], "name": cfg["name"], "status": status,
            "wall_s": round(time.time() - t0, 3), "metrics": metrics}


def run(args) -> dict:
    from ..parallel import mesh

    report = {"harness": "ccvpe_torch.eval", "baseline": "BASELINE.json configs 1-5",
              "results": [run_config(c) for c in build_configs(args)]}
    report["n_ok"] = sum(r["status"] == "ok" for r in report["results"])
    report["n_failed"] = sum(r["status"] == "failed" for r in report["results"])
    if args.out and mesh.rank() == 0:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2, default=str)
        print(f"wrote {args.out}")
    return report
