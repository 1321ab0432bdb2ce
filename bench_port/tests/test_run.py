"""``run.py`` measures only on a card, and the harness imports no jax."""

from __future__ import annotations

import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from bench_port.lib.common import BENCH_DIR, ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "visual_rag_tpu", "bench", "benchmarks",
             "chip_smoke")


def _run(cwd, *args):
    return subprocess.run([sys.executable, "bench_port/run.py", *args], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))


def test_refuses_without_a_card():
    assert not torch.cuda.is_available()
    out = _run(ROOT, "--workload", "colqwen25.search.b1024", "--seed", "3", "--seconds", "1",
               "--trace", "0")
    assert out.returncode == 3, out.stderr
    assert out.stdout == ""
    assert "CUDA card" in out.stderr


def test_refuses_in_a_checkout_without_the_program(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH_DIR, tmp_path / "bench_port",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = _run(tmp_path, "--workload", "colsmol.ingest.b8", "--seed", "3",
               "--seconds", "1", "--trace", "1")
    assert out.returncode != 0
    assert out.stdout == ""


def test_nothing_under_bench_port_imports_jax_or_the_jax_package():
    for path in BENCH_DIR.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in FORBIDDEN, f"{path}: imports {n}"


def test_loading_every_module_leaves_jax_unloaded():
    code = ("import sys, runpy, pathlib; sys.path.insert(0, '.');"
            "from bench_port.lib import common;"
            "[common.load_module(p) for p in sorted(pathlib.Path('bench_port').rglob('*.py'))"
            " if 'tests' not in p.parts and p.name != '__init__.py'];"
            "import visual_rag_tpu_torch.retrieval.engine, visual_rag_tpu_torch.models.train;"
            "assert not [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
            "'visual_rag_tpu')], 'jax loaded'")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr


def test_the_jax_side_is_found_by_whole_top_level_names(monkeypatch):
    from bench_port.lib import common

    monkeypatch.setitem(sys.modules, "visual_rag_tpu_torch_extra", object())
    monkeypatch.setitem(sys.modules, "jaxtyping", object())
    assert not {"visual_rag_tpu_torch_extra", "jaxtyping"} & set(common.jax_side_loaded())
    monkeypatch.setitem(sys.modules, "jax.numpy", object())
    monkeypatch.setitem(sys.modules, "visual_rag_tpu.models", object())
    assert {"jax.numpy", "visual_rag_tpu.models"} <= set(common.jax_side_loaded())


READER_RUN = '''
import sys, pathlib, torch
sys.path[:0] = [{root!r}, {stub!r}]
import bench_port.run as run
from bench_port.lib import common
bench = pathlib.Path({bench!r})
cell = common.Cell({{"name": "stub.cell", "chips": 1}}, {{"model_type": "stub"}},
                   {{"kind": "stub"}}, [], [{{"name": "reader", "unit": "%"}}], bench)
run.common.load_cell = lambda name: cell
torch.cuda.is_available = lambda: True
torch.cuda.device_count = lambda: 1
torch.cuda.set_device = lambda device: None
torch.cuda.get_device_name = lambda index=0: "stub card"
sys.exit(run.main(["--workload", "stub.cell", "--seed", "3", "--seconds", "1",
                   "--trace", "1"]))
'''

STUB_KIND = '''from bench_port.lib import common


def run(ctx):
    return common.Outcome(1, 0, {}, {"gap": common.Limit(0.0, 1.0)}, 0)
'''


@pytest.mark.parametrize("imports_jax", [False, True])
def test_a_reader_that_loads_jax_leaves_no_result(tmp_path, imports_jax):
    """The look for JAX comes after the readers: one that imports a module
    named ``jax`` inside ``read`` stops the result line."""
    (tmp_path / "stub" / "jax").mkdir(parents=True)
    (tmp_path / "stub" / "jax" / "__init__.py").write_text("")
    for sub in ("kinds", "metrics"):
        (tmp_path / "bench" / sub).mkdir(parents=True)
    (tmp_path / "bench" / "kinds" / "stub.py").write_text(STUB_KIND)
    (tmp_path / "bench" / "metrics" / "reader.py").write_text(
        "def read(facts):\n" + ("    import jax  # noqa: F401\n" if imports_jax else "")
        + "    return 50.0\n")
    code = READER_RUN.format(root=str(ROOT), stub=str(tmp_path / "stub"),
                             bench=str(tmp_path / "bench"))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    if imports_jax:
        assert out.returncode == 4, out.stderr
        assert out.stdout == ""
        assert "['jax']" in out.stderr
    else:
        assert out.returncode == 0, out.stderr
        assert json.loads(out.stdout.splitlines()[-1])["metrics"]["reader"]["value"] == 50.0
