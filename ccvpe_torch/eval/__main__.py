"""``python -m ccvpe_torch.eval``: run the BASELINE configs, write a report."""

import argparse

from . import run


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Run the five BASELINE.json eval configs through the port's CLIs "
                    "and write a JSON report")
    p.add_argument("--configs", type=str, default="all",
                   help='"all" or comma-separated ids, e.g. "1,3,5"')
    p.add_argument("--vigor_root", type=str, default="datasets/VIGOR")
    p.add_argument("--kitti_root", type=str, default="datasets/KITTI")
    p.add_argument("--oxford_root", type=str, default="datasets/Oxford_5m_sampling/")
    p.add_argument("--vigor_samearea_model", type=str, default="",
                   help="reference-format .pt; empty = seeded random weights")
    p.add_argument("--vigor_crossarea_model", type=str, default="")
    p.add_argument("--kitti_model", type=str, default="")
    p.add_argument("--oxford_model", type=str, default="")
    p.add_argument("--orientation_dir", type=str, default="",
                   help="frozen-orientation fixtures (default: the shipped fixtures/)")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--steps", type=int, default=0,
                   help="limit eval batches per config (0 = full set)")
    p.add_argument("--num_workers", type=int, default=8)
    p.add_argument("--results_dir", type=str, default="results/baseline_eval")
    p.add_argument("--model_preset", type=str, default="",
                   help="override the per-dataset model preset (e.g. NANO for smoke runs)")
    p.add_argument("--out", type=str, default="baseline_report.json")
    return p.parse_args(argv)


def main(argv=None):
    from ..parallel import mesh

    mesh.maybe_init_distributed()
    report = run(parse_args(argv))
    for r in report["results"]:
        print(f"[{r['status']}] config {r['id']}: {r['name']} ({r['wall_s']}s)")
    # the per-config CLIs finalize already; this covers the report's write
    mesh.finalize_run("eval-runner-complete")
    return report


if __name__ == "__main__":
    main()
