"""Run one cell of the port's benchmark on this machine's card:

    python3 portbench/run.py --workload NAME --seed N --seconds S --trace 0|1

from the root of a checkout.  Exits non-zero, printing no result, without
a CUDA card, or when the process holds JAX or the JAX package once the
window has closed.  The kernels' libraries and every other cache are
kept inside the checkout, under ``build/``.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    for var, sub in (("CUDA_CACHE_PATH", "cuda_cache"), ("TRITON_CACHE_DIR", "triton_cache"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(ROOT / "build" / sub)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    import repro_torch  # noqa: F401  (the program under test: without it, fail before any output)
    from portbench import harness

    spec = harness.load_spec()
    chips = harness.entry(spec["workloads"], args.workload, "workload")["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    print(json.dumps({"card": harness.nvidia_smi(), "torch": torch.__version__,
                      "cuda": torch.version.cuda}), flush=True)
    cell = harness.make_cell(spec, args.workload, args.seed, args.seconds, bool(args.trace),
                             "cuda", STARTED)
    outcome = harness.run_cell(cell)
    found = harness.forbidden_modules()
    if found:
        print(f"the process holds {found} after the window: the benchmark imports none of "
              f"JAX or the JAX package", file=sys.stderr)
        return 3
    result, notes = harness.result_line(spec, cell, outcome)
    for line in notes:
        print(line)
    for name, c in result["checks"].items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
