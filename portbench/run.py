"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout, on a machine with the card(s) the cell asks
for. Set-up loads the port and warms the cell's shapes; then the window
measures for ``--seconds``; with ``--trace 1`` a short profiled stretch
follows; then the plain reference checks what the window produced. The
last line of standard output is the result; the compared numbers and
their limits are the last lines of standard error. Without a card the
command exits 2 and prints no result.
"""

import time

T0 = time.monotonic()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if sys.path[0] == os.path.dirname(os.path.abspath(__file__)):
    sys.path.pop(0)
sys.path.insert(0, ROOT)

# Caches of anything that compiles stay in the checkout, at fixed paths.
_CACHE = os.path.join(ROOT, ".portbench_cache")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_CACHE, "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_CACHE, "torch_extensions")
os.environ["CUDA_CACHE_PATH"] = os.path.join(_CACHE, "nv")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness

    cell = harness.load_cell(args.workload)
    harness.require_chips(cell.chips)
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           "cuda", T0)
    harness.print_result(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
