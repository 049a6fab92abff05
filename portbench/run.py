"""Run one cell of the port's benchmark on the card and print its result.

    python3 portbench/run.py --workload gbdt-higgs.grid --seed 7 --seconds 40 --trace 0

From the root of a checkout. The program is the checkout's ``src/repro_torch``
(its kernels are built into the checkout's ``build/`` on the first run and
loaded from there after). The last line of standard output is one JSON
object: ``correct``, ``attempted`` and ``failed`` (fits), ``metrics`` (the
cell's end-to-end metrics with ``--trace 0``, its per-layer metrics with
``--trace 1``), ``device``, with ``--trace 1`` a ``breakdown`` of the device
trace, and last ``compared``: each number of the comparison that decides
``correct`` with its limit, which also end standard error. Exits non-zero
and prints no result without a CUDA device, without the program, or when
a module of jax or of the JAX package is loaded once the window has closed.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True, help="a cell of BENCHMARK.json")
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True, help="the measured window")
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import manifest

    cell = manifest.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"the program is not in this checkout ({ROOT / 'src'}): {e}", file=sys.stderr)
        return 2
    from portbench import harness

    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_START)
    bad = harness.forbidden_modules()
    if bad:
        print("modules of jax or of the JAX package are loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    sys.stdout.flush()
    for name, v in result["compared"].items():
        print(f"{name} {v['value']!r} limit {v['limit']}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
