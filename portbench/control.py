"""The readings that a cell's limits are set from, on the card at the cell's
own size: for each seed, a short window of the program at the cell's load
and its numbers against the reference (the lower readings); for the first
``--control-seeds`` seeds also the control's, the reference computed with
TF32 matmuls put in the program's place (the upper readings).

    python3 -m portbench.control --workload <name> --seeds 11 12 13 ...
        [--control-seeds 3] [--seconds 3]

One JSON line a seed. The benchmark's own runs do not run this.
"""

import argparse
import json
import sys
import time

import torch

from portbench import drivers, spec


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    cell = spec.load(args.workload)
    for i, seed in enumerate(args.seeds):
        t = time.perf_counter()
        driver = drivers.make(cell.config, cell.traffic, cell.limits, seed, "cuda")
        win = driver.run(args.seconds, False)
        driver.release()
        line = {"seed": seed, "calls": win.calls, "failed": win.failed,
                "program": driver.numbers()}
        if i < args.control_seeds:
            line["control"] = driver.control()
        line["seconds"] = time.perf_counter() - t
        print(json.dumps(line), flush=True)
        del driver
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
