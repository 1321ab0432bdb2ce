"""Read a cell's control on the card: the plain reference put in the
program's place, in the precision below the configuration's, on several
seeds (for a training cell also the faults a step can have, planted in the
reference). Its readings are the upper ends the limits of ``correct`` are
set below (PERF.md gives them). The benchmark's own runs do not run it.

    python3 bench_port/control.py --workload <name> --seeds 11 12 13
    python3 bench_port/control.py --workload <training cell> --seeds 14 15 --faults
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from bench_port.lib import common  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--faults", nargs="*", default=None,
                    help="a training cell's control and faults to read (default: all; "
                         "none named: the program's own readings alone)")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        common.log("the control runs on the card")
        return 3
    cell = common.load_cell(args.workload)
    kind = cell.kind_module()
    for seed in args.seeds:
        ctx = common.RunContext(cell, seed, args.seconds, False, torch.device("cuda", 0))
        if not hasattr(kind, "faults"):
            readings = {"control": kind.control(ctx)}
        elif args.faults is None:
            readings = kind.faults(ctx)
        else:
            readings = kind.faults(ctx, tuple(args.faults))
        print(json.dumps({"workload": cell.name, "seed": seed, "readings": readings,
                          "limits": cell.traffic["limits"]}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
