"""Kimi-VL-A3B-Instruct's configuration, architecture module, reference,
cell and readers, added to the harness as new files: every architecture
keeps the contract of ``arch/__init__.py``, Kimi's FLOPs, attention calls
and expert work against hand counts at tiny shapes, the cell at the CPU cut,
the route agreement's bookkeeping, and the routed layers' roofline reader
against hand-made spans."""

from __future__ import annotations

import types

import numpy as np
import pytest

from bench_port.lib import common, model_work, spans as spans_lib, weights
from bench_port.lib.trace import DeviceTrace
from bench_port.tests import tiny

WORKLOAD = "kimivl.ingest.b8"
# the cell's mix at the CPU cut: pages of a few hundred patches
TINY_TRAFFIC = dict(page_sizes=[[300, 200], [250, 420]], pool_pages=4, batch=2, call_pages=4,
                    sample=3)
# every architecture module and the configuration that runs it
ARCHS = {"idefics3": "colsmol-500m", "qwen2_5_vl": "colqwen25-v0.2",
         "kimi_vl": "kimi-vl-a3b-instruct"}
ARCH_CONTRACT = ("BACKEND", "sizes", "leaves", "program_config", "vocab", "forward_flops",
                 "attention_calls", "tiny")
REFERENCE_CONTRACT = ("process_page", "prompt_ids", "Reference", "page_vectors", "exact_f32")


@pytest.fixture
def kimi_cell(monkeypatch):
    """The cell at the CPU cut, in f32."""
    traffic = common.load_cell(WORKLOAD).workload["traffic"]
    monkeypatch.setitem(tiny.TRAFFIC, traffic, TINY_TRAFFIC)
    cell = tiny.cell(WORKLOAD)
    cell.config["torch_dtype"] = "float32"
    return cell


def _reader(name):
    return common.load_module(common.BENCH_DIR / "metrics" / f"{name}.py").read


def _span_readers():
    """The per-layer metrics the cell lists that read the program's spans."""
    cell = common.load_cell(WORKLOAD)
    return [m["name"] for m in cell.per_layer if m["source"] == "program_span"]


# -- the contract -------------------------------------------------------------------


def test_the_table_holds_every_configuration():
    configs = (common.BENCH_DIR / "configs").glob("*.json")
    types_ = {common.load_json(p)["model_type"] for p in configs}
    assert types_ == set(ARCHS)


@pytest.mark.parametrize("model_type", sorted(ARCHS))
def test_every_architecture_keeps_the_contract(model_type):
    """Each module provides the contract of ``arch/__init__.py``, its CPU cut
    fits the program's model leaf for leaf, its reference provides the
    kinds' functions, and a page of its reference's processor is counted."""
    from visual_rag_tpu_torch.models.colvlm import ColVLM

    cfg = common.load_json(common.BENCH_DIR / "configs" / f"{ARCHS[model_type]}.json")
    assert cfg["model_type"] == model_type
    arch = common.arch_module(cfg)
    assert all(hasattr(arch, name) for name in ARCH_CONTRACT)
    cut = arch.tiny(cfg)
    weights.check_names(arch.leaves(cut),
                        ColVLM(arch.program_config(cut), device="meta").state_dict())
    ref = common.load_module(common.BENCH_DIR / "reference" / f"{cfg['reference']}.py")
    assert all(hasattr(ref, name) for name in REFERENCE_CONTRACT)
    page = ref.process_page(np.zeros((300, 200, 3), np.uint8), cut)
    page["n_prompt"] = len(ref.prompt_ids(arch.vocab(cut)))
    layout = model_work.page_layout(page)
    assert arch.forward_flops(cut, [layout], [5]) > arch.forward_flops(cut, [layout], []) > 0
    calls = arch.attention_calls(cut, [layout], [])
    assert calls and all(c[4] in (layout["patches"], layout["text"]) for c in calls)


# -- arithmetic ---------------------------------------------------------------------

TINY_KIMI = {
    "model_type": "kimi_vl",
    "vision_config": {"hidden_size": 4, "num_hidden_layers": 2, "num_attention_heads": 2,
                      "intermediate_size": 6, "patch_size": 1, "init_pos_emb_height": 2,
                      "init_pos_emb_width": 2, "merge_kernel_size": [2, 2]},
    "hidden_size": 8, "num_hidden_layers": 2, "num_attention_heads": 2, "intermediate_size": 10,
    "moe_intermediate_size": 3, "kv_lora_rank": 4, "qk_nope_head_dim": 2, "qk_rope_head_dim": 2,
    "v_head_dim": 2, "n_routed_experts": 4, "num_experts_per_tok": 2, "n_shared_experts": 1,
    "first_k_dense_replace": 1, "vocab_size": 20, "embedding_dim": 3,
}
KIMI_PAGE = {"patches": 8, "segments": [8], "image_tokens": 2, "text": 3}
KIMI = common.arch_module(TINY_KIMI)


def test_kimi_forward_flops_hand_count():
    vision = 2 * 8 * (3 * 4 + 2 * (4 * 16 + 2 * 4 * 6))
    merger = 2 * 2 * ((4 * 4) ** 2 + 16 * 8)
    vision_attention = 4 * 4 * 2 * 64  # 4 x hidden a pair and layer, 8 x 8 pairs (full)
    attn = 8 * 2 * 4 + 8 * 6 + 4 * 2 * 4 + 2 * 2 * 8  # q, kv_a, kv_b, o
    dense, routed = attn + 3 * 8 * 10, attn + 8 * 4 + (2 + 1) * 3 * 8 * 3  # 2 routed + 1 shared
    per_token = dense + routed + 8 * 3
    pair = 2 * (2 + 2 + 2) * 2  # q.k over nope + rope, p.v over v, 2 heads
    text = 2 * (3 + 2) * per_token + pair * 2 * (6 + 3)  # causal pairs of 3 and 2 tokens
    want = vision + merger + vision_attention + text
    assert KIMI.forward_flops(TINY_KIMI, [KIMI_PAGE], [2]) == want == 16432


def test_kimi_attention_calls_and_expert_work():
    calls = KIMI.attention_calls(TINY_KIMI, [KIMI_PAGE], [2])
    # latent attention as dh 3: (2 x (2 + 2) + 2 x 2) / 4
    assert calls == [(64, 2, 2, 2, 8)] * 2 + [(6, 2, 2, 3, 3)] * 2 + [(3, 2, 2, 3, 2)] * 2
    nbytes, flops = KIMI.moe_work(TINY_KIMI, [KIMI_PAGE], [2])
    assert flops == 2 * 5 * (8 * 4 + (2 + 1) * 3 * 8 * 3)  # 5 tokens, one routed layer
    # every expert reachable (min(4, 5 x 2)) and the shared one, in bf16; the f32 router;
    # x in and the output out in bf16
    assert nbytes == (4 + 1) * 3 * 8 * 3 * 2 + 4 * 8 * 4 + 2 * 5 * 8 * 2
    one = KIMI.moe_work(TINY_KIMI, [{**KIMI_PAGE, "text": 1}], [])
    assert one[0] == (2 + 1) * 3 * 8 * 3 * 2 + 4 * 8 * 4 + 2 * 1 * 8 * 2  # 1 token: 2 experts


# -- the cell at the CPU cut --------------------------------------------------------


def test_kimivl_cell_runs_at_a_tiny_size_in_f32(kimi_cell):
    """The new cell's files, at the CPU cut in f32: the window's pages
    through the program, the reference's vectors within the cell's limits,
    and the cell's model FLOPs counted."""
    out = tiny.run(kimi_cell, trace=True)
    assert out.correct, out.compared
    assert out.facts["model_flops"] > 0 and out.end_to_end["ingest_pages_per_s"] > 0
    assert "moe_roofline.kimivl" in [m["name"] for m in kimi_cell.per_layer]


def test_a_profiled_tiny_run_gives_each_span_reader_its_spans(kimi_cell):
    """The CPU has no device trace: a CPU profiler session turns the spans
    on, and the untraced window (no device interval, all of it idle) is read
    by every reader of the cell that reads host spans."""
    from torch.profiler import ProfilerActivity, profile

    from visual_rag_tpu_torch import tracing

    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        facts = tiny.run(kimi_cell).facts
    names = [n for n in _span_readers() if n != "moe_roofline.kimivl"]  # reads device time
    assert names
    for name in names:
        value = _reader(name)(facts)
        assert value is not None and value > 0, name
    recorded = {s.name for s in spans_lib.program_spans()}
    assert {"vision.tower", "text.decoder", "moe.experts"} <= recorded
    tracing.clear()


def test_route_agreement_compares_each_sides_own_choices(kimi_cell):
    """``route_agreement.py`` at the CPU cut in f32: every routed layer of
    each sampled page recorded on both sides, over the page's valid tokens
    only; the same f32 model on both sides differs in few choices."""
    from bench_port import route_agreement
    from bench_port.kinds import ingest

    ctx = common.RunContext(kimi_cell, tiny.SEED, 0.0, False, tiny.CPU)
    pool = ingest.page_pool(kimi_cell.traffic, tiny.SEED)
    call = ingest.call_pages(kimi_cell.traffic, pool, 0)
    batches = [call[:2], call[2:4]]
    prog = route_agreement.program_routes(ctx, batches)
    refr = route_agreement.reference_routes(ctx, batches, 1)
    routed = kimi_cell.config["num_hidden_layers"] - kimi_cell.config["first_k_dense_replace"]
    for key, layers in refr.items():
        assert len(layers) == len(prog[key]) == routed
        assert all(got.shape == want.shape for got, (want, _) in zip(prog[key], layers))
    out = route_agreement.compare(prog, refr)
    assert out["pairs"] == sum(layers[0][0].shape[0] for layers in refr.values()) * routed
    assert 0 <= out["choices_differ"] <= out["pairs_differ"] < 0.05


# -- the routed layers' roofline ----------------------------------------------------


def _span(name, start, end, device_ms=None, **counts):
    return types.SimpleNamespace(name=name, start_ns=start, end_ns=end, device_ms=device_ms,
                                 counts=counts)


def _trace():
    """Window [1000, 2000] ns, the device busy over part of it."""
    tr = DeviceTrace(False)
    tr.events = [("a", 900, 1100), ("b", 1300, 1500)]
    tr.t0_ns, tr.t1_ns = 1000, 2000
    return tr


# routed layers: 3 + 5 ms of device time in the window, one span past it
MOE_SPANS = [
    _span("moe.experts", 1020, 1040, device_ms=3.0, tokens=16),
    _span("moe.experts", 1040, 1060, device_ms=5.0, tokens=16),
    _span("moe.experts", 1990, 2010, device_ms=100.0, tokens=16),
]
# an architecture whose routed layers read 3.35e9 bytes a forward (1 ms at 3.35 TB/s)
MOE_ARCH = types.SimpleNamespace(moe_work=lambda cfg, pages, queries: (3.35e9, 1e6))


def test_moe_roofline_is_the_least_time_over_the_spans_device_time(monkeypatch):
    read = _reader("moe_roofline.kimivl")
    facts = {"trace": _trace(), "arch": MOE_ARCH, "config": {}, "forwards": [([], [])] * 2}
    monkeypatch.setattr(spans_lib, "program_spans", lambda: list(MOE_SPANS))
    assert read(facts) == pytest.approx(25.0)
    assert read({**facts, "arch": types.SimpleNamespace()}) is None
    assert read({}) is None  # an untraced run has no trace
    monkeypatch.setattr(spans_lib, "program_spans", lambda: [])
    assert read(facts) is None


def test_moe_roofline_reads_nothing_from_a_program_without_spans(monkeypatch):
    """A parent commit without the tracing module: no reading, nothing raised."""
    import sys

    import visual_rag_tpu_torch

    monkeypatch.delattr(visual_rag_tpu_torch, "tracing", raising=False)
    monkeypatch.setitem(sys.modules, "visual_rag_tpu_torch.tracing", None)
    facts = {"trace": _trace(), "arch": MOE_ARCH, "config": {}, "forwards": [([], [])]}
    assert _reader("moe_roofline.kimivl")(facts) is None
