"""What every cell shares: finding its files by name, the run's context, the
process clock, and the result line.

A cell is one entry of ``workloads`` in ``BENCHMARK.json``. It names a
configuration (``bench_port/configs/<config>.json``) and a traffic mix
(``bench_port/traffic/<traffic>.json``); the mix names its ``kind``, the
general generator and loop in ``bench_port/kinds/<kind>.py`` that reads it. The
configuration's ``model_type`` names its architecture's module,
``bench_port/arch/<model_type>.py``, and its ``reference`` the plain reference,
``bench_port/reference/<reference>.py`` (``bench_port/arch/__init__.py`` says
what each provides). A per-layer metric is the reader
``bench_port/metrics/<name>.py``. Nothing here knows a cell, a mix, an
architecture or a metric by name.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib.util
import json
import os
import sys
import time
from pathlib import Path
from typing import Any, Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


def load_json(path: Path) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """Import a file by its path (metric files carry dots in their names)."""
    name = f"bench_port_{path.parent.name}_{path.stem}".replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def arch_module(cfg: Dict[str, Any], bench_dir: Path = BENCH_DIR):
    """The module of the configuration's architecture,
    ``bench_port/arch/<model_type>.py``."""
    path = bench_dir / "arch" / f"{cfg['model_type']}.py"
    if not path.is_file():
        raise FileNotFoundError(
            f"{cfg.get('name', 'the configuration')}: no module for model_type "
            f"{cfg['model_type']!r}; add bench_port/arch/{cfg['model_type']}.py "
            "(bench_port/arch/__init__.py says what it provides)")
    return load_module(path)


@dataclasses.dataclass
class Cell:
    """One workload with everything it names, read from the benchmark's files."""

    workload: Dict[str, Any]
    config: Dict[str, Any]
    traffic: Dict[str, Any]
    end_to_end: List[Dict[str, Any]]
    per_layer: List[Dict[str, Any]]
    bench_dir: Path = BENCH_DIR

    @property
    def name(self) -> str:
        return self.workload["name"]

    def kind_module(self):
        return load_module(self.bench_dir / "kinds" / f"{self.traffic['kind']}.py")

    @functools.cached_property
    def arch(self):
        """The configuration's architecture module, loaded once a cell."""
        return arch_module(self.config, self.bench_dir)

    def reference_module(self, name: Optional[str] = None):
        """``bench_port/reference/<name>.py``; by default the configuration's
        own (its model's plain reference)."""
        name = name or self.config["reference"]
        return load_module(self.bench_dir / "reference" / f"{name}.py")


def _applies(metric: Dict[str, Any], name: str) -> bool:
    return name in metric.get("workloads", [name])


def load_cell(name: str, benchmark: Optional[Dict[str, Any]] = None,
              bench_dir: Path = BENCH_DIR) -> Cell:
    """The workload ``name`` of ``BENCHMARK.json`` (beside ``bench_dir``) and
    the files it names. Per-layer metrics without a ``workloads`` list apply
    where their end-to-end metric is reported."""
    bench = benchmark or load_json(bench_dir.parent / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if name not in by_name:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(by_name)}")
    wl = by_name[name]
    configs = {c["name"]: c for c in bench["configs"]}
    entry = configs[wl["config"]]
    config = load_json(bench_dir.parent / entry["file"])
    traffic = load_json(bench_dir / "traffic" / f"{wl['traffic']}.json")
    e2e = [m for m in bench["end_to_end"] if _applies(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in reported)]
    return Cell(wl, config, traffic, e2e, per_layer, bench_dir)


def process_age_s() -> float:
    """Seconds since this process started, from the kernel's own record
    (``/proc/self/stat`` field 22 against ``/proc/uptime``), so that the
    interpreter's start and the imports count as set-up."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):  # no procfs: count from this import
        return time.perf_counter() - _IMPORTED_AT


_IMPORTED_AT = time.perf_counter()


@dataclasses.dataclass
class RunContext:
    """One run of one cell: ``--seed``, ``--seconds``, ``--trace``, and the
    device it runs on (the card; the CPU only in the harness's own tests)."""

    cell: Cell
    seed: int
    seconds: float
    trace: bool
    device: Any

    @property
    def params(self) -> Dict[str, Any]:
        return self.cell.traffic


@dataclasses.dataclass
class Limit:
    """A number compared for ``correct`` and the limit it may not pass."""

    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Outcome:
    """What a kind's run hands back to ``run.py``."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # metric name -> value, the cell's own metrics
    compared: Dict[str, Limit]
    memory_peak_bytes: int
    facts: Dict[str, Any] = dataclasses.field(default_factory=dict)  # for the readers
    notes: List[str] = dataclasses.field(default_factory=list)  # earlier stderr lines

    @property
    def correct(self) -> bool:
        return bool(self.compared) and all(c.ok for c in self.compared.values()) \
            and self.failed == 0


class Marks:
    """Process ages at the steps of a set-up, for the stderr notes."""

    def __init__(self):
        self.marks = [("start", process_age_s())]

    def __call__(self, name: str) -> None:
        self.marks.append((name, process_age_s()))

    def note(self) -> str:
        steps = [f"{n} {t - p:.2f}" for (_, p), (n, t) in zip(self.marks, self.marks[1:])]
        return f"set-up s: at start {self.marks[0][1]:.2f}; " + ", ".join(steps)


JAX_SIDE = ("jax", "jaxlib", "flax", "visual_rag_tpu")


def jax_side_loaded() -> List[str]:
    """The modules of JAX or of the JAX package that this process holds,
    compared by whole top-level names (the port's package name starts with
    the JAX package's)."""
    return sorted(m for m in sys.modules if m.split(".")[0] in JAX_SIDE)


def log(*parts) -> None:
    print(*parts, file=sys.stderr, flush=True)
