"""The readings a cell's output limits are set from, on the card.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1 2 3 ... \
        --control-seeds 1 2 3 --seconds 4 [--out FILE]

For each seed: the cell's set-up, a window of ``--seconds`` at the cell's
own load, and the numbers ``correct`` compares, of the program (the lower
reading is the largest over the seeds) and, for ``--control-seeds``, of the
control (the reference computed in TF32 in the program's place) and of the
cell's faults (training: half the batch, a state left unchanged, each in
every checked step or from the second on, inside one call): the
upper reading is the smallest. One JSON line a seed, on standard output and
appended to ``--out``. The benchmark's own runs never run this.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from benchmark.core import cell as cells  # noqa: E402

def readings(cell, seed: int, seconds: float, sides, device) -> dict:
    """One seed of ``cell`` on ``device``: set-up, a window of ``seconds``,
    and the numbers of each of ``sides`` ("program", "control" and the
    cell's faults)."""
    import torch

    kind = cells.kind(cell.traffic["kind"])
    t0 = time.perf_counter()
    st = kind.setup(cell, seed, device)
    t1 = time.perf_counter()
    _, calls = kind.window(st, seconds)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t2 = time.perf_counter()
    got = kind.numbers(st, sides)
    row = {"workload": cell.name, "seed": seed, "calls": len(calls),
           "failed": sum(not c.ok for c in calls), "setup_s": t1 - t0,
           "reference_s": time.perf_counter() - t2, **got}
    del st
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = cells.resolve(args.workload)
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        sides = ("program",)
        if seed in args.control_seeds:
            sides += ("control",) + cells.kind(cell.traffic["kind"]).FAULTS
        line = json.dumps(readings(cell, seed, args.seconds, sides, device))
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
