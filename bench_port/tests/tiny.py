"""Tiny cells for the CPU tests: the real configuration and traffic files
with every size cut to what a test run holds (widths too: these are for
the harness's control flow and arithmetic, not for measurements)."""

from __future__ import annotations

import copy
import json

import torch

from bench_port.lib import common

CPU = torch.device("cpu")
SEED = 2**31 + 977  # larger than 32 signed bits, as a check's seeds may be


def load(rel: str):
    return json.loads((common.BENCH_DIR / rel).read_text())


def qwen_config():
    cfg = load("configs/colqwen25-v0.2.json")
    cfg.update(hidden_size=64, intermediate_size=96, num_hidden_layers=2, num_attention_heads=4,
               num_key_value_heads=2, vocab_size=1000, image_token_id=999, max_visual_tokens=64,
               rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]})
    cfg["vision_config"] = dict(cfg["vision_config"], depth=3, hidden_size=32,
                                intermediate_size=48, num_heads=2, fullatt_block_indexes=[1],
                                out_hidden_size=64)
    return cfg


def smol_config():
    cfg = load("configs/colsmol-500m.json")
    cfg["text_config"] = dict(cfg["text_config"], hidden_size=64, intermediate_size=96,
                              num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                              vocab_size=1000)
    cfg["vision_config"] = dict(cfg["vision_config"], hidden_size=32, intermediate_size=64,
                                num_hidden_layers=2, num_attention_heads=2)
    cfg["image_token_id"] = 999
    return cfg


TRAFFIC = {
    "search_b1024_200k": dict(docs=300, tokens=[40, 64], pooled_rows=8, pooled_valid=[6, 8],
                              batch=64, pool_batches=2, sample=16),
    "train_b4_a4": dict(pairs=3, page_px=[120, 90], query_tokens=[5, 9],
                        pool_steps=2),
    "ingest_b8_a4_letter": dict(page_sizes=[[300, 200], [600, 500]], pool_pages=4, batch=2,
                                call_pages=4, sample=3),
}
CONFIGS = {"colqwen25-v0.2": qwen_config, "colsmol-500m": smol_config}


def cell(workload: str, **over) -> common.Cell:
    """``BENCHMARK.json``'s workload at a tiny size."""
    c = common.load_cell(workload)
    c.config = CONFIGS[c.workload["config"]]()
    c.traffic = {**copy.deepcopy(c.traffic), **TRAFFIC[c.workload["traffic"]], **over}
    return c


def run(c: common.Cell, seconds: float = 0.3, trace: bool = False) -> common.Outcome:
    return c.kind_module().run(common.RunContext(c, SEED, seconds, trace, CPU))
