"""Tiny cells for the CPU tests: the real configuration and traffic files
with every size cut to what a test run holds (widths too: these are for
the harness's control flow and arithmetic, not for measurements). Each
architecture's module cuts its configurations (``arch/<model_type>.py::tiny``)."""

from __future__ import annotations

import copy
import json

import torch

from bench_port.lib import common

CPU = torch.device("cpu")
SEED = 2**31 + 977  # larger than 32 signed bits, as a check's seeds may be


def load(rel: str):
    return json.loads((common.BENCH_DIR / rel).read_text())


def config(name: str):
    """The configuration file ``name`` cut by its architecture's ``tiny``."""
    cfg = load(f"configs/{name}.json")
    return common.arch_module(cfg).tiny(cfg)


TRAFFIC = {
    "search_b1024_200k": dict(docs=300, tokens=[40, 64], pooled_rows=8, pooled_valid=[6, 8],
                              batch=64, pool_batches=2, sample=16),
    "train_b4_a4": dict(pairs=3, page_px=[120, 90], query_tokens=[5, 9],
                        pool_steps=2),
    "ingest_b8_a4_letter": dict(page_sizes=[[300, 200], [600, 500]], pool_pages=4, batch=2,
                                call_pages=4, sample=3),
}


def cell(workload: str, **over) -> common.Cell:
    """``BENCHMARK.json``'s workload at a tiny size."""
    c = common.load_cell(workload)
    c.config = c.arch.tiny(c.config)
    c.traffic = {**copy.deepcopy(c.traffic), **TRAFFIC[c.workload["traffic"]], **over}
    return c


def run(c: common.Cell, seconds: float = 0.3, trace: bool = False) -> common.Outcome:
    return c.kind_module().run(common.RunContext(c, SEED, seconds, trace, CPU))
