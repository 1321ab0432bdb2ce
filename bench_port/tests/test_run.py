"""``run.py`` measures only on a card, and the harness imports no jax."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

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
