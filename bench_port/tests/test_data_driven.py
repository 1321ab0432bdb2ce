"""A later change adds a configuration, an architecture, a traffic mix, a
cell and a per-layer metric with new files and new entries in
``BENCHMARK.json`` only: the harness finds each by its name, and no file it
already has is edited."""

from __future__ import annotations

import hashlib
import json
import shutil

from bench_port.lib import common
from bench_port.tests import tiny


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


def test_new_config_traffic_cell_and_metric_are_found_by_name(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(common.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)

    # new files only
    cfg = tiny.config("colsmol-500m")
    cfg["name"] = "colsmol-tiny"
    (bench_dir / "configs" / "colsmol-tiny.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "search_b1024_200k.json").read_text())
    mix.update(tiny.TRAFFIC["search_b1024_200k"], batch=32)
    (bench_dir / "traffic" / "search_tiny.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "batches.search_tiny.py").write_text(
        "def read(facts):\n    return facts.get('batches') or None\n")
    # new entries, and the new cell's name in its metric's list
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "colsmol-tiny", "source": "https://example.org/tiny",
                             "file": "bench_port/configs/colsmol-tiny.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "colsmol.search.tiny", "config": "colsmol-tiny",
                               "traffic": "search_tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "batches.search_tiny", "unit": "batches",
                               "better": "lower", "source": "program_counter",
                               "layer": "engine plans", "moves": "search_qps",
                               "workloads": ["colsmol.search.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "search_qps":
            m["workloads"].append("colsmol.search.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = common.load_cell("colsmol.search.tiny", bench_dir=bench_dir)
    assert cell.config["name"] == "colsmol-tiny" and cell.traffic["batch"] == 32
    assert [m["name"] for m in cell.per_layer] == ["batches.search_tiny"]
    assert {m["name"] for m in cell.end_to_end} == {"search_qps", "setup_s"}
    out = cell.kind_module().run(common.RunContext(cell, tiny.SEED, 0.3, False, tiny.CPU))
    assert out.correct
    run = common.load_module(bench_dir / "run.py")
    line = run.result_line(cell, out, True, "cpu", 1)
    assert line["metrics"]["batches.search_tiny"]["value"] == out.facts["batches"] > 0
    assert list(line)[-1] == "compared"
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before


TWIN_ARCH = '''"""Idefics3's architecture under a model_type of its own."""
from pathlib import Path

from bench_port.lib.common import load_module

_base = load_module(Path(__file__).with_name("idefics3.py"))
BACKEND = _base.BACKEND
sizes, leaves, program_config, vocab = _base.sizes, _base.leaves, _base.program_config, _base.vocab
forward_flops, attention_calls, tiny = _base.forward_flops, _base.attention_calls, _base.tiny
'''
TWIN_REFERENCE = '''from bench_port.reference.colvlm import (  # noqa: F401
    Reference, exact_f32, page_vectors, process_page, prompt_ids)
'''
FLOPS_READER = '''def read(facts):
    if "forwards" not in facts:
        return None
    arch, cfg = facts["arch"], facts["config"]
    return sum(arch.forward_flops(cfg, pages, queries) for pages, queries in facts["forwards"])
'''


def test_new_architecture_is_added_with_new_files_only(tmp_path):
    shutil.copy(common.ROOT / "BENCHMARK.json", tmp_path)
    bench_dir = tmp_path / "bench_port"
    shutil.copytree(common.BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__"))
    before = _digests(bench_dir)

    # new files only: the architecture, its configuration, its reference, an
    # ingest mix and a reader that counts the window's work through the module
    (bench_dir / "arch" / "smolvlm_twin.py").write_text(TWIN_ARCH)
    (bench_dir / "reference" / "smolvlm_twin.py").write_text(TWIN_REFERENCE)
    cfg = tiny.config("colsmol-500m")
    cfg.update(name="smolvlm-twin", model_type="smolvlm_twin", reference="smolvlm_twin",
               torch_dtype="float32")  # f32 at this size, as the fault tests run it
    (bench_dir / "configs" / "smolvlm-twin.json").write_text(json.dumps(cfg))
    mix = json.loads((bench_dir / "traffic" / "ingest_b8_a4_letter.json").read_text())
    mix.update(tiny.TRAFFIC["ingest_b8_a4_letter"])
    (bench_dir / "traffic" / "ingest_tiny.json").write_text(json.dumps(mix))
    (bench_dir / "metrics" / "forward_flops.ingest_tiny.py").write_text(FLOPS_READER)
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "smolvlm-twin", "source": "https://example.org/twin",
                             "file": "bench_port/configs/smolvlm-twin.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "smolvlm_twin.ingest.tiny", "config": "smolvlm-twin",
                               "traffic": "ingest_tiny", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "forward_flops.ingest_tiny", "unit": "FLOP",
                               "better": "higher", "source": "program_counter",
                               "layer": "embedder", "moves": "ingest_pages_per_s",
                               "workloads": ["smolvlm_twin.ingest.tiny"]})
    for m in bench["end_to_end"]:
        if m["name"] == "ingest_pages_per_s":
            m["workloads"].append("smolvlm_twin.ingest.tiny")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = common.load_cell("smolvlm_twin.ingest.tiny", bench_dir=bench_dir)
    assert cell.arch.__file__ == str(bench_dir / "arch" / "smolvlm_twin.py")
    out = cell.kind_module().run(common.RunContext(cell, tiny.SEED, 0.3, True, tiny.CPU))
    assert out.correct, out.compared
    assert out.facts["arch"].__file__ == str(bench_dir / "arch" / "smolvlm_twin.py")
    assert len(out.facts["forwards"]) == out.facts["calls"] * 2  # two batches a call
    run = common.load_module(bench_dir / "run.py")
    line = run.result_line(cell, out, True, "cpu", 1)
    assert line["metrics"]["forward_flops.ingest_tiny"]["value"] == out.facts["model_flops"] > 0
    after = _digests(bench_dir)
    assert {k: v for k, v in after.items() if k in before} == before
