"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 evalbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the program
(``torcheval_tpu_torch``) on a machine with the cards the cell asks for.
The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, in a traced run
``breakdown``, and last ``checks``: each number compared with the
reference beside its limit); the checks are also the last lines of
standard error. Without CUDA, with fewer cards than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, the run
exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout, so only a checkout's
# first run builds (the port's own K1 build already lives in build/)
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, "build", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from evalbench import guard, harness, spec

    cell = spec.cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"evalbench: {args.workload} needs {cell.chips} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    found = guard.violations()
    if found:
        print("evalbench: the run loaded what it may not:\n  " + "\n  ".join(found), file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(harness.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
