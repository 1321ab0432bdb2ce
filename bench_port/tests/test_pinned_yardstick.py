"""The yardstick of both configurations at full size, pinned to the values
the harness computed before each architecture's knowledge moved into its own
module (``bench_port/arch/``): the leaf table, the FLOPs and attention calls
of fixed page batches, the program's configuration, the vocabulary, the
processor backend and the CPU cut; and the weights of the CPU cut as the
draw of one flat f32 buffer gave them. Moving or sharing code may change
none of them."""

from __future__ import annotations

import dataclasses
import hashlib
import json

import pytest
import torch

from bench_port.lib import common, weights
from bench_port.tests import tiny

# an A4 page of ColQwen2.5 (74 x 54 patches in 8 x 8 windows) and of ColSmol
# (13 tiles), and a US letter page of ColSmol (17 tiles), as the reference's
# processor lays them out
QWEN_A4 = {"patches": 3996, "segments": ([64] * 6 + [48]) * 9 + [16] * 6 + [12],
           "image_tokens": 999, "text": 1003}
SMOL_A4 = {"patches": 13312, "segments": [1024] * 13, "image_tokens": 832, "text": 836}
SMOL_LETTER = {"patches": 17408, "segments": [1024] * 17, "image_tokens": 1088, "text": 1092}
QUERIES = [12, 20, 32, 17]

PINNED = {
    "colqwen25-v0.2": {
        "leaves": 954, "parameters": 3754132608,
        "table_sha256": "55b5fba64caaca211e98d562e5d30081a09e7d850f59291df83ac96094154eac",
        "first": [("vision.patch_embed.weight", (1280, 588), "matrix"),
                  ("vision.blocks.0.ln1.scale", (1280,), "scale"),
                  ("vision.blocks.0.attn.q.weight", (1280, 1280), "matrix")],
        "last": [("final_norm.scale", (2048,), "scale"),
                 ("proj.weight", (128, 2048), "matrix"), ("proj.bias", (128,), "bias")],
        "pages": [QWEN_A4, QWEN_A4],
        "flops": {True: 22831193178112.0, False: 22381390741504.0},
        "calls": [((487200, 16, 16, 80, 7992), 7), ((31936032, 16, 16, 80, 7992), 1)] * 4
        + [((1007012, 16, 2, 128, 2006), 36)],
        "query_calls": [((969, 16, 2, 128, 81), 36)],
        "program_config": (
            "ColVLMConfig(vision=VisionConfig(hidden=1280, layers=32, heads=16, "
            "mlp_ratio=2.671875, patch_pixels=588, max_patches=4096, window_side=8, "
            "full_attn_layers=(7, 15, 23, 31), pixel_shuffle=1, attn_bias=True, mlp_gated=True, "
            "rms_norm=True, patch_bias=False, learned_pos=False, post_ln=False, rope_2d=True, "
            "rope_theta=10000.0), text=TextConfig(hidden=2048, layers=36, heads=16, kv_heads=2, "
            "mlp_hidden=11008, vocab=151936, rope_theta=1000000.0, max_seq=4096, "
            "scan_layers=False, moe_experts=0, moe_top_k=2, moe_capacity_factor=1.25, "
            "ring_axis=None, attn_qkv_bias=True, mlp_act='silu', rms_offset=False, "
            "embed_scale=False, causal=True, mrope_section=(16, 24, 24)), embed_dim=128, "
            "spatial_merge=2, image_token_id=151655, dtype='bfloat16', remat=False, "
            "proj_bias=True, connector_bias=True, hf_layout='qwen2.5')"),
        "backend": "colqwen2.5", "vocab": 151936,
        "tiny_sha256": "e92d10e26c370c56210cefa4270cab45f5a21faeba7f820738bb3373ddfa2169",
        "drawn_sha256": {
            "f32": "a41db8387df1e4cd2bc48b0a37d0915347000198ef8a7daaf3f56728e3a6607e",
            "serving_1000":
                "831316b8423fd2d6ba2f1646e6b22463a14dbee765e7a1d5d0f6f396048be063"},
    },
    "colsmol-500m": {
        "leaves": 490, "parameters": 460296512,
        "table_sha256": "c75ba8f3116673fb2c53e190e9f8b2cf22f49bbdb67ff94193adc48fc0a7bf26",
        "first": [("vision.patch_embed.weight", (768, 768), "matrix"),
                  ("vision.patch_embed.bias", (768,), "bias"),
                  ("vision.pos_embed", (1024, 768), "table")],
        "last": [("final_norm.scale", (960,), "scale"),
                 ("proj.weight", (128, 960), "matrix"), ("proj.bias", (128,), "bias")],
        "pages": [SMOL_A4, SMOL_LETTER],
        "flops": {True: 7840453632000.0, False: 7789353861120.0},
        "calls": [((31457280, 12, 12, 64, 30720), 12), ((946644, 15, 5, 64, 1928), 32)],
        "query_calls": [((969, 15, 5, 64, 81), 32)],
        "program_config": (
            "ColVLMConfig(vision=VisionConfig(hidden=768, layers=12, heads=12, mlp_ratio=4.0, "
            "patch_pixels=768, max_patches=18432, window_side=0, full_attn_layers=(), "
            "pixel_shuffle=4, attn_bias=True, mlp_gated=False, rms_norm=False, patch_bias=True, "
            "learned_pos=True, post_ln=True, rope_2d=False, rope_theta=10000.0), "
            "text=TextConfig(hidden=960, layers=32, heads=15, kv_heads=5, mlp_hidden=2560, "
            "vocab=49280, rope_theta=100000.0, max_seq=4096, scan_layers=False, moe_experts=0, "
            "moe_top_k=2, moe_capacity_factor=1.25, ring_axis=None, attn_qkv_bias=False, "
            "mlp_act='silu', rms_offset=False, embed_scale=False, causal=True, "
            "mrope_section=None), embed_dim=128, spatial_merge=1, image_token_id=49190, "
            "dtype='bfloat16', remat=False, proj_bias=True, connector_bias=False, "
            "hf_layout='idefics3')"),
        "backend": "colsmol", "vocab": 49280,
        "tiny_sha256": "d3a46125f8496e19e8113dd5781e60120b9ce849503dfcf2f27f62e7af0fd733",
        "drawn_sha256": {
            "f32": "ad64cafccc7d55e69378fcdb986e4466ebfd1d9739d05121c51d3c1d4d1b3bea",
            "serving_1000":
                "1a4937ee4ee51d807ac44e2e77ebbabadb982756fdef2c5cd69622d45d74bca7"},
    },
}
CONFIGS = sorted(PINNED)


def _load(name):
    cfg = common.load_json(common.BENCH_DIR / "configs" / f"{name}.json")
    return cfg, common.arch_module(cfg)


def _runs(calls):
    out = []
    for c in calls:
        if out and out[-1][0] == c:
            out[-1][1] += 1
        else:
            out.append([c, 1])
    return [(c, n) for c, n in out]


@pytest.mark.parametrize("name", CONFIGS)
def test_leaf_table_is_pinned(name):
    cfg, arch = _load(name)
    pin = PINNED[name]
    table = [(leaf.name, leaf.shape, leaf.kind) for leaf in arch.leaves(cfg)]
    text = "\n".join(f"{n} {s} {k}" for n, s, k in table)
    assert len(table) == pin["leaves"]
    assert sum(leaf.numel for leaf in arch.leaves(cfg)) == pin["parameters"]
    assert table[:3] == pin["first"] and table[-3:] == pin["last"]
    assert hashlib.sha256(text.encode()).hexdigest() == pin["table_sha256"]


@pytest.mark.parametrize("queries", [True, False], ids=["with_queries", "pages_only"])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_work_is_pinned(name, queries):
    cfg, arch = _load(name)
    pin = PINNED[name]
    qlens = QUERIES if queries else []
    assert arch.forward_flops(cfg, pin["pages"], qlens) == pin["flops"][queries]
    want = pin["calls"] + (pin["query_calls"] if queries else [])
    assert _runs(arch.attention_calls(cfg, pin["pages"], qlens)) == want


@pytest.mark.parametrize("name", CONFIGS)
def test_program_config_backend_vocab_and_cut_are_pinned(name):
    cfg, arch = _load(name)
    pin = PINNED[name]
    pcfg = arch.program_config(cfg)
    assert repr(pcfg) == pin["program_config"]
    assert arch.program_config(cfg, remat=True) == dataclasses.replace(pcfg, remat=True)
    assert (arch.BACKEND, arch.vocab(cfg)) == (pin["backend"], pin["vocab"])
    tiny = json.dumps(arch.tiny(cfg), sort_keys=True)
    assert hashlib.sha256(tiny.encode()).hexdigest() == pin["tiny_sha256"]
    assert cfg == _load(name)[0]  # the cut is a copy


def _digest(params):
    h = hashlib.sha256()
    for name, t in params.items():
        h.update(name.encode())
        h.update(t.detach().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", CONFIGS)
def test_drawn_weights_are_pinned(name, monkeypatch):
    """The CPU cut's weights from ``tiny.SEED``: in f32 (the reference's and
    the trainer's), and in the serving dtypes with chunks of 1000 normals, so
    that leaves straddle them. Each digest is over every leaf's name and
    bytes, in the table's order."""
    from bench_port.kinds import ingest

    cfg = tiny.config(name)
    arch = common.arch_module(cfg)
    pin = PINNED[name]["drawn_sha256"]
    assert _digest(weights.draw(arch.leaves(cfg), tiny.SEED, tiny.CPU)) == pin["f32"]
    monkeypatch.setattr(weights, "CHUNK", 1000)
    served = ingest.serving_state(arch.leaves(cfg), arch.program_config(cfg), tiny.SEED,
                                  tiny.CPU)
    assert _digest(served) == pin["serving_1000"]


def test_an_unknown_architecture_names_the_file_to_add():
    with pytest.raises(FileNotFoundError, match="add bench_port/arch/kimi_vl.py"):
        common.arch_module({"name": "kimi-vl-a3b", "model_type": "kimi_vl"})
