"""Run one cell of the port's benchmark once and print its result line.

    python3 bench_port/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Reads ``BENCHMARK.json`` at the root of the checkout, the configuration and
the traffic mix the workload names, and the mix's kind
(``bench_port/kinds/<kind>.py``), which sets up, measures the window and
checks the window's answers against the plain reference. With ``--trace 0``
the line's metrics are the cell's end-to-end metrics; with ``--trace 1``
the window runs under the device profiler and the metrics are the cell's
per-layer metrics, each from its reader ``bench_port/metrics/<name>.py``
(a reader that finds nothing returns None and the metric is left out).

The last lines on standard error are the numbers compared for ``correct``,
each beside its limit; the last line on standard output is the result.
Without a CUDA card, or with fewer than the cell asks for, it exits 3 and
prints no result; if the process holds JAX or the JAX package once the window
has closed, it names what it found and exits 4 with no result.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# every kernel and build cache at a fixed path inside the checkout, so only
# the first run of a cell in a checkout builds (the program's own library
# builds into build/kernels/ beside the package)
CACHE = ROOT / "build" / "bench_cache"
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(CACHE / _sub)
os.environ.setdefault("OMP_NUM_THREADS", "4")  # one process, few threads

from bench_port.lib import common  # noqa: E402


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "nvidia-smi not readable"


def result_line(cell: common.Cell, out: common.Outcome, trace: bool, device_kind: str,
                chips: int) -> dict:
    """The contract's result object; ``compared`` comes last."""
    metrics = {}
    if trace:
        for m in cell.per_layer:
            reader = common.load_module(cell.bench_dir / "metrics" / f"{m['name']}.py")
            value = reader.read(out.facts)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]], "unit": m["unit"]}
    device = {"platform": "gpu", "kind": device_kind, "count": chips,
              "memory_peak_bytes": out.memory_peak_bytes}
    line = {"correct": out.correct, "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": device}
    tr = out.facts.get("trace")
    if trace and tr is not None:
        device["busy_s"] = tr.busy_s
        device["window_s"] = tr.window_s
        line["breakdown"] = tr.breakdown()
    line["compared"] = {k: {"value": c.value, "limit": c.limit}
                        for k, c in out.compared.items()}
    return line


def main(argv=None) -> int:
    args = parse_args(argv)
    cell = common.load_cell(args.workload)
    import torch

    chips = int(cell.workload["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        common.log(f"{cell.name} needs {chips} CUDA card(s); "
                   f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    common.log(f"{cell.name}: seed {args.seed}, {args.seconds} s, trace {args.trace}; "
               f"card {card_line()}")
    ctx = common.RunContext(cell, args.seed, args.seconds, bool(args.trace), device)
    out = cell.kind_module().run(ctx)
    line = result_line(cell, out, bool(args.trace), torch.cuda.get_device_name(0), chips)
    loaded = common.jax_side_loaded()  # after the readers, which may import too
    if loaded:
        common.log(f"{cell.name}: the process holds JAX or the JAX package: {loaded[:10]}; "
                   "no result")
        return 4
    for note in out.notes:
        common.log(note)
    tr = out.facts.get("trace")
    if args.trace and tr is not None:
        common.log("idle by host phase (s): " + json.dumps(tr.idle_by_phase()))
    for name, c in out.compared.items():
        common.log(f"compared {name} = {c.value!r}, limit {c.limit!r}: "
                   f"{'ok' if c.ok else 'FAILED'}")
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
