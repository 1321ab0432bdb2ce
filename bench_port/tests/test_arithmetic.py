"""The yardstick's arithmetic against hand counts at tiny shapes."""

from __future__ import annotations

import types

import pytest

from bench_port.lib import common, model_work, peaks, readers
from bench_port.lib.trace import DeviceTrace, union_ns

TINY_QWEN = {
    "model_type": "qwen2_5_vl",
    "vision_config": {"hidden_size": 4, "depth": 2, "num_heads": 2, "intermediate_size": 6,
                      "patch_size": 14, "spatial_merge_size": 2, "fullatt_block_indexes": [1]},
    "hidden_size": 8, "num_hidden_layers": 1, "num_attention_heads": 2,
    "num_key_value_heads": 1, "intermediate_size": 10, "vocab_size": 20, "embedding_dim": 3,
}
PAGE = {"patches": 8, "segments": [4, 4], "image_tokens": 2, "text": 3}
QWEN = common.arch_module(TINY_QWEN)


def test_least_seconds_takes_the_larger_bound():
    assert peaks.least_seconds(3.35e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_seconds(0.0, 989e12) == pytest.approx(1.0)
    assert peaks.least_seconds(3.35e12, 2 * 989e12) == pytest.approx(2.0)


def test_rerank_work_counts_each_distinct_doc_once():
    nbytes, ops = peaks.rerank_work([3, 5], [(2, 3), (2, 5), (1, 3)], dim=4, itemsize=2,
                                    b=2, nq=2, k=2)
    # rows 8 x 4 x 2 B, queries 2 x 2 x 4 f32, mask 2 x 2 f32, candidates 3 x 2 x 2 int32
    assert nbytes == 64 + 64 + 16 + 48
    assert ops == 2 * 4 * (2 * 3 + 2 * 5 + 1 * 3)


def test_pooled_stage1_work():
    nbytes, ops = peaks.pooled_stage1_work(valid_rows=10, rows=12, docs=3, dim=4, itemsize=2,
                                           b=2)
    assert nbytes == 12 * 4 * 2 + 12 + 2 * 4 * 4 + 2 * 3 * 4
    assert ops == 2 * 4 * 2 * 10


def test_allowed_pairs_and_attention_work():
    assert peaks.allowed_pair_count([2, 3], causal=False) == 13
    assert peaks.allowed_pair_count([2, 3], causal=True) == 3 + 6
    nbytes, ops = peaks.attention_work(pairs=10, heads=2, kv_heads=1, dh=4, rows=3)
    assert (nbytes, ops) == (48 + 48 + 48, 4 * 4 * 2 * 10)
    nbytes, ops = peaks.attention_work(pairs=10, heads=2, kv_heads=1, dh=4, rows=3,
                                       backward=True)
    assert (nbytes, ops) == (2 * (48 + 48) + 2 * 48 + 3 * 2 * 4, 10 * 4 * 2 * 10)


def test_forward_flops_hand_count():
    vision = 2 * 8 * (588 * 4 + 2 * (4 * 16 + 3 * 4 * 6))
    merger = 2 * 2 * ((4 * 4) ** 2 + 16 * 8)
    vision_attention = 4 * 2 * 2 * (32 + 64)  # a window layer, then the full one
    text_layer = 2 * 64 + 2 * 8 * 1 * 4 + 3 * 8 * 10
    text = 2 * (3 + 2) * (text_layer + 8 * 3)
    text_attention = 4 * 4 * 2 * (6 + 3)  # causal pairs of 3 and 2 tokens
    want = vision + merger + vision_attention + text + text_attention
    assert QWEN.forward_flops(TINY_QWEN, [PAGE], [2]) == want == 49904


def test_attention_calls_and_their_least_time():
    calls = QWEN.attention_calls(TINY_QWEN, [PAGE], [2])
    assert calls == [(32, 2, 2, 2, 8), (64, 2, 2, 2, 8), (6, 2, 1, 4, 3), (3, 2, 1, 4, 2)]
    one = model_work.attention_least_s(calls[:1], forwards=1, backward=False)
    assert one == pytest.approx(peaks.least_seconds(*peaks.attention_work(32, 2, 2, 2, 8)))
    two = model_work.attention_least_s(calls[:1], forwards=2, backward=True)
    back = peaks.least_seconds(*peaks.attention_work(32, 2, 2, 2, 8, backward=True))
    assert two == pytest.approx(2 * one + back)


def _trace(events, t0, t1):
    tr = DeviceTrace(False)
    tr.events, tr.t0_ns, tr.t1_ns = events, t0, t1
    return tr


def test_idle_is_the_window_outside_the_union_of_device_intervals():
    assert union_ns([(0, 5), (3, 8), (10, 12)]) == [(0, 8), (10, 12)]
    tr = _trace([("a", 0, 50), ("b", 30, 60), ("c", 80, 100)], 0, 200)
    assert tr.busy_s == pytest.approx(80e-9)
    assert readers.idle_pct({"trace": tr}) == pytest.approx(60.0)
    assert readers.idle_pct({"trace": _trace([], 0, 10)}) is None


def test_rooflines_and_mfu():
    tr = _trace([("flash_fwd_lse_mma_kernel", 0, 4_000_000_000),
                 ("other", 0, 1_000_000_000)], 0, 10_000_000_000)
    facts = {"trace": tr, "attention_kernels": ("flash_fwd_lse",), "attention_least_s": 1.0,
             "model_flops": 989e12}
    assert readers.attention_roofline_pct(facts) == pytest.approx(25.0)
    assert readers.mfu_pct(facts) == pytest.approx(10.0)
    assert readers.roofline_pct(1.0, 0.0) is None  # nothing of the kernel in the trace


def test_breakdown_lists_ops_and_gaps_by_phase():
    tr = _trace([("k1", 10, 20), ("k2", 40, 45)], 0, 100)
    tr.phases = [("input pipeline", 15, 42)]
    b = tr.breakdown()
    assert b["device_ops"] == [["k1", 10e-9], ["k2", 5e-9]]
    assert b["idle_gaps"][0] == ["untracked host", 55e-9]
    assert ["input pipeline", 20e-9] in b["idle_gaps"]
    assert set(b) == {"device_ops", "idle_gaps"}


def test_search_readers_use_the_recorded_work():
    from bench_port.lib.common import BENCH_DIR, load_module

    tr = _trace([("void vrt::dedup_kernel<bf16>", 0, 2_000_000_000)], 0, 4_000_000_000)
    work = [(3.35e12, 0.0, 3.35e12 * 0.5, 0.0)]  # rerank 1 s, stage-1 0.5 s at the least
    facts = {"trace": tr, "work": work}
    roof = load_module(BENCH_DIR / "metrics" / "rerank_roofline.py")
    mfu = load_module(BENCH_DIR / "metrics" / "mfu.search.py")
    assert roof.read(facts) == pytest.approx(50.0)
    assert mfu.read(facts) == pytest.approx(100.0 * 1.5 / 4.0)
    assert roof.read(types.SimpleNamespace(get=lambda k: None)) is None
