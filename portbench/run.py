"""Runs one cell of BENCHMARK.json once on the card and prints one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

With ``--trace 0`` the line's metrics are the cell's end-to-end metrics,
with ``--trace 1`` its per-layer metrics (torch.profiler over a part of the
window and over the set-up's seals). Without as many CUDA cards as the cell
asks for it exits with 2 and prints no result; it never runs on the CPU.
``--control 1`` puts the control (exact search in TF32 arithmetic) in the
program's place: the comparison must then find the run not correct.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

_T_START = time.perf_counter()


def _cache_dirs():
    """Every build and kernel cache inside the checkout, at a fixed path."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cache = os.path.join(root, "portbench_cache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(cache, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(cache, "triton"))
    os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    from portbench import spec

    cell = spec.cell(spec.load_benchmark(), args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {cell.name} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)

    from portbench import harness

    result = harness.run(cell, args.seed, args.seconds, bool(args.trace), "cuda",
                         _T_START, system="control" if args.control else "port")
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: loaded in the run's process: {', '.join(bad)}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
