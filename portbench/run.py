"""The benchmark of ``ccvpe_torch`` on one NVIDIA card: one run of one cell.

    python3 portbench/run.py --workload vigor-infer-b8 --seed 7 --seconds 10 --trace 0

Prints the compared numbers beside their limits as the last lines of
standard error, and one JSON object as the last line of standard output:
``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's end-to-end
metrics, or with ``--trace 1`` its per-layer ones), ``device`` and, traced,
``breakdown``; ``checks`` comes last.  Exits non-zero, printing no result,
without a CUDA card, without the program, or when the JAX package or JAX
itself was loaded.  See portbench/README.md.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0,
                    help="1: trace the window and report the per-layer metrics")
    ap.add_argument("--control", action="store_true",
                    help="run the program in the precision below the configuration's "
                         "(the control that the comparison must fail; tests only)")
    args = ap.parse_args(argv)
    root = Path(__file__).resolve().parents[1]
    sys.path.insert(0, str(root))
    from portbench.lib import harness

    harness.cache_dirs(root)
    cell = harness.load_cell(args.workload, root)
    try:
        import torch

        import ccvpe_torch  # noqa: F401
    except ImportError as e:
        print(f"portbench: cannot import the program under test: {e}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    ctx = harness.Context(cell, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda"), T0,
                          harness.precision_of(cell.config, args.control))
    result, lines = harness.run(ctx)
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the benchmark measures ccvpe_torch alone",
              file=sys.stderr)
        return 3
    print("\n".join(lines), file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
