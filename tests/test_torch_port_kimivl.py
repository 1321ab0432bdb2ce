"""The port's Kimi-VL path against the plain reference, on the CPU.

The JAX package has no such model, so the oracle is the benchmark's plain
reference (``bench_port/reference/kimivl.py``: f32, one page at a time,
written from the published architecture). Both sides run the configuration
file cut to ``bench_port/arch/kimi_vl.py::tiny`` (MoonViT 144 wide on 2 heads
of 72, an 8 x 8 position table; a 128-wide decoder of 1 dense and 2 routed
layers, latent rank 32 with 16 + 8 q/k and 16-wide v heads, 8 experts, top
3, 2 shared) in f32, on one set of seeded weights (``lib/weights.py``).

Tolerances: modules compare at 1e-5 of their outputs' scale (f32 on both
sides; only the order of the sums differs, and the port's latent attention
adds exact zeros from its padding to head dim 256). The routed layer is
also held to a per-token loop over each token's chosen experts (the
layer's definition, written here) at 1e-5. The whole page's stored vectors compare at 1e-4: the same f32 model,
with the reference given the f16-rounded pixels the embedder ships, through
5 layers and the poolings. The processor's patches are equal bit for bit.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from bench_port.lib import common, weights
from bench_port.reference import kimivl as ref
from visual_rag_tpu_torch.models import colvlm as C
from visual_rag_tpu_torch.models.convert import build_model
from visual_rag_tpu_torch.models.embedder import VisualEmbedder
from visual_rag_tpu_torch.models.processors import ImageProcessor
from visual_rag_tpu_torch.ops.kernels import moe_experts as me
from visual_rag_tpu_torch.pipeline.vectors import page_vectors

SEED = 2**31 + 5
FULL = common.load_json(common.BENCH_DIR / "configs" / "kimi-vl-a3b-instruct.json")
ARCH = common.arch_module(FULL)


def _close(got, want, tol):
    got, want = (torch.as_tensor(a).detach().double() for a in (got, want))
    scale = max(1.0, float(want.abs().max()))
    assert float((got - want).abs().max()) <= tol * scale


@pytest.fixture(scope="module")
def tiny():
    """(file cut, program config, f32 params, port model, reference)."""
    cfg = ARCH.tiny(FULL)
    cfg["torch_dtype"] = "float32"
    pcfg = ARCH.program_config(cfg)
    params = weights.draw(ARCH.leaves(cfg), SEED, torch.device("cpu"))
    model = build_model(pcfg, {k: v.clone() for k, v in params.items()}, "cpu")
    return cfg, pcfg, params, model, ref.Reference(cfg, params)


def _grid_inputs(gh, gw, hidden, seed=0):
    """Row-major activations of a (gh, gw) grid, and the permutation to the
    processor's merge-block order with its (row, col) positions."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(gh * gw, hidden, generator=gen)
    rows = np.repeat(np.arange(gh), gw).reshape(gh, gw)
    cols = np.tile(np.arange(gw), (gh, 1))

    def merge(a):
        return a.reshape(gh // 2, 2, gw // 2, 2).transpose(0, 2, 1, 3).reshape(-1)

    order = torch.from_numpy(merge(rows) * gw + merge(cols))
    pos = torch.from_numpy(np.stack([merge(rows), merge(cols)], -1).astype(np.int32))
    return x, order, pos


def test_full_model_builds_on_meta_with_every_leaf_and_its_count():
    pcfg = ARCH.program_config(FULL)
    assert pcfg == dataclasses.replace(C.ColVLMConfig.kimi_vl_a3b())
    meta = C.ColVLM(pcfg, device="meta").state_dict()
    weights.check_names(ARCH.leaves(FULL), meta)
    assert sum(v.numel() for v in meta.values()) == 16_072_374_000
    assert sum(leaf.numel for leaf in ARCH.leaves(FULL)) == 16_072_374_000


def test_check_supported_takes_routed_experts_and_refuses_the_softmax_moe():
    cfg = C.ColVLMConfig.kimi_vl_a3b()
    C.check_supported(cfg)
    with pytest.raises(NotImplementedError, match=r"text\.moe_experts"):
        C.check_supported(dataclasses.replace(cfg, text=dataclasses.replace(
            cfg.text, moe_experts=8)))


@pytest.mark.parametrize("grid", [(6, 4), (8, 8), (10, 6)])
def test_interpolated_positions(tiny, grid):
    _, _, _, model, reference = tiny
    _, order, pos = _grid_inputs(*grid, 144)
    got = model.vision.grid_positions(pos[None], [grid])[0]
    _close(got, reference.positions(grid)[order], 1e-6)


def test_moonvit_block_with_its_rotary(tiny):
    _, _, _, model, reference = tiny
    gh, gw = 6, 4
    x, order, pos = _grid_inputs(gh, gw, 144, seed=1)
    n = gh * gw
    pad = 8  # a page padded past its patches: the pads may not reach the valid rows
    xp = torch.cat([x[order], torch.randn(pad, 144)])[None]
    mask = torch.arange(n + pad)[None] < n
    posp = torch.cat([pos, torch.zeros(pad, 2, dtype=torch.int32)])[None]
    got = model.vision.blocks[0](xp, mask, positions_2d=posp)[0, :n]
    dh = 72
    inv = 10000.0 ** (-torch.arange(0, dh, 4, dtype=torch.float32)[: dh // 4] / dh)
    rows = torch.arange(gh).repeat_interleave(gw).float()
    cols = torch.arange(gw).repeat(gh).float()
    angles = torch.stack([cols[:, None] * inv, rows[:, None] * inv], -1).reshape(n, -1)
    want = reference.vit_block(0, x, angles)[order]
    _close(got, want, 1e-5)


def test_latent_attention(tiny):
    cfg, _, _, model, reference = tiny
    t, pad = 11, 5
    gen = torch.Generator().manual_seed(2)
    x = torch.randn(1, t + pad, 128, generator=gen)
    mask = torch.arange(t + pad)[None] < t
    positions = (torch.cumsum(mask.int(), 1) - 1).clamp(min=0)
    got = model.layers[0].attn(x, mask, positions)[0, :t]
    rope = cfg["qk_rope_head_dim"]
    inv = cfg["rope_theta"] ** (-torch.arange(0, rope, 2, dtype=torch.float32) / rope)
    angles = torch.arange(t).float()[:, None] * inv
    _close(got, reference.mla(0, x[0, :t], angles), 1e-5)


def _moe_case(model, reference, bias=None, seed=3, t=40):
    """The port's layer 1 against the reference's, with the router's bias set."""
    layer = model.layers[1].mlp
    if bias is not None:
        with torch.no_grad():
            layer.router.bias.copy_(bias)
        reference.p["layers.1.mlp.router.bias"] = layer.router.bias.detach().clone()
    gen = torch.Generator().manual_seed(seed)
    x = torch.randn(1, t, 128, generator=gen)
    got = layer(x)[0]
    _close(got, reference.moe(1, x[0]), 1e-5)
    return layer, x[0]


def test_routed_layer(tiny):
    _, _, params, model, reference = tiny
    layer, x = _moe_case(model, reference)
    idx, w = layer.route(x)
    assert idx.shape == (40, 3)
    _close(w.sum(-1), torch.full((40,), 2.446), 1e-6)  # normalised, then scaled
    reference.p["layers.1.mlp.router.bias"] = params["layers.1.mlp.router.bias"]


def test_routed_layer_where_the_bias_decides_and_experts_get_no_token(tiny):
    _, _, params, model, reference = tiny
    bias = torch.zeros(8)
    bias[5] = 4.0  # above every score's spread: expert 5 is every token's choice ...
    bias[[0, 1]] = -4.0  # ... and experts 0 and 1 nobody's
    before = model.layers[1].mlp.stats["tokens"].clone()
    layer, x = _moe_case(model, reference, bias=bias, seed=4)
    idx, w = layer.route(x)
    scores = torch.sigmoid(x @ layer.router.weight.T)
    assert bool((idx == 5).any(-1).all()) and not bool(torch.isin(idx, torch.tensor([0, 1])).any())
    # the weights are the raw scores' (not score + bias), normalised
    raw = scores.gather(1, idx)
    _close(w, raw / raw.sum(-1, keepdim=True) * 2.446, 1e-6)
    counts = layer.stats["tokens"] - before
    assert counts.tolist() == torch.bincount(idx.reshape(-1), minlength=8).tolist()
    assert counts[0] == counts[1] == 0 and counts[5] == 40
    with torch.no_grad():
        layer.router.bias.copy_(params["layers.1.mlp.router.bias"])
    reference.p["layers.1.mlp.router.bias"] = params["layers.1.mlp.router.bias"]


def _moe_per_token(x, router_w, bias, experts, shared, top_k: int, scaling: float):
    """The routed layer as its definition reads, one token at a time over its
    chosen experts. ``experts``, ``shared``: (gate, up, down) weights."""
    scores = torch.sigmoid(x @ router_w.T)
    out = (F.silu(x @ shared[0].T) * (x @ shared[1].T)) @ shared[2].T
    rows = []
    for t in range(x.shape[0]):
        idx = torch.topk(scores[t] + bias, top_k).indices
        w = scores[t, idx] / (scores[t, idx].sum() + 1e-20) * scaling
        acc = out[t]
        for j, e in enumerate(idx.tolist()):
            g, u, d = (m[e] for m in experts)
            acc = acc + w[j] * ((F.silu(g @ x[t]) * (u @ x[t])) @ d.T)
        rows.append(acc)
    return torch.stack(rows)


def test_grouped_experts_plain_version_is_the_per_token_loop(tiny):
    _, _, _, model, _ = tiny
    layer = model.layers[2].mlp
    gen = torch.Generator().manual_seed(5)
    x = torch.randn(1, 25, 128, generator=gen)
    e, s = layer.experts, layer.shared
    want = _moe_per_token(
        x[0], layer.router.weight.detach(), layer.router.bias.detach(),
        (e.gate.weight.detach(), e.up.weight.detach(), e.down.weight.detach()),
        (s.gate.weight.detach(), s.up.weight.detach(), s.down.weight.detach()),
        top_k=3, scaling=2.446)
    _close(layer(x)[0].detach(), want, 1e-5)


def test_layout_sorts_pairs_by_expert_with_offsets_tiles_and_slots():
    idx = torch.tensor([[2, 0], [2, 3], [0, 2], [3, 2]])
    lay = me.expert_layout(idx, 5)
    assert lay.counts.tolist() == [2, 0, 4, 2, 0]
    assert lay.offsets.tolist() == [0, 2, 2, 6, 8, 8]
    assert lay.tile_starts.tolist() == [0, 1, 1, 2, 3, 3]
    assert lay.tokens.tolist() == [0, 2, 0, 1, 2, 3, 1, 3]  # stable: tokens in order
    flat = idx.reshape(-1)
    for pair, row in enumerate(lay.slots.reshape(-1).tolist()):
        assert lay.tokens[row] == pair // 2
        assert lay.offsets[flat[pair]] <= row < lay.offsets[flat[pair] + 1]
    assert lay.max_tiles == 1 + 5


def test_routed_forward_reads_nothing_back_and_stats_count_the_routing(tiny, monkeypatch):
    """The layer's forward (routing, layout, the count) calls no ``.item``,
    ``.cpu``, ``.tolist``, ``.numpy`` nor a tensor's ``__int__``/``__index__``:
    none of them is allowed while it runs, with the expert kernel's call
    replaced by a record of its inputs (its plain version, which runs only
    on the CPU, reads the offsets)."""
    _, _, _, model, _ = tiny
    layer = model.layers[2].mlp
    seen = {}

    def kernel(x, gate, up, down, layout, w, base=None):
        seen["layout"] = layout
        return base

    monkeypatch.setattr(C, "moe_experts", kernel)
    before = layer.stats["tokens"].clone()
    x = torch.randn(2, 9, 128)

    def forbidden(*a, **k):
        raise AssertionError("a read back to the host in the forward")

    with monkeypatch.context() as m:
        for name in ("item", "cpu", "tolist", "numpy", "__int__", "__index__", "__bool__"):
            m.setattr(torch.Tensor, name, forbidden)
        layer(x)
    idx, _ = layer.route(x.reshape(-1, 128))
    counts = torch.bincount(idx.reshape(-1), minlength=8)
    assert (layer.stats["tokens"] - before).tolist() == counts.tolist()
    assert seen["layout"].counts.tolist() == counts.tolist()


@pytest.mark.parametrize("hw", [(1754, 1240), (2200, 1700)], ids=["a4_150dpi", "letter_200dpi"])
def test_processor_follows_the_published_rule(hw):
    proc = ImageProcessor("kimivl", image_token_id=163605, patch_pixels=588, vocab=163840,
                          max_visual_tokens=1024)
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)
    out = proc.process_images([img])
    page = ref.process_page(img, FULL)
    gh, gw = page["grid"]
    assert (gh, gw) == {(1754, 1240): (78, 54), (2200, 1700): (74, 58)}[hw]
    info = out.token_infos[0]
    assert (info["grid_h"], info["grid_w"]) == (gh, gw)
    assert info["num_visual_tokens"] == page["n_image_tokens"] == gh * gw // 4
    _, order, pos = _grid_inputs(gh, gw, 1)
    n = gh * gw
    assert np.array_equal(out.patches[0, :n], page["patches"][order.numpy()])
    assert np.array_equal(out.patch_positions[0, :n], pos.numpy())
    ids = out.input_ids[0][out.attn_mask[0]].tolist()
    assert ids == ref.page_ids(FULL, page["n_image_tokens"], 163840)
    assert info["visual_token_indices"] == list(range(2, 2 + page["n_image_tokens"]))


def test_routed_layers_record_their_spans(tiny):
    """Under a profiler each routed layer records a ``moe.experts`` span
    (its rows as ``tokens``) inside the decoder's span; on the CPU none has
    a device time."""
    from torch.profiler import ProfilerActivity, profile

    from visual_rag_tpu_torch import tracing

    _, _, _, model, _ = tiny
    ids = torch.full((2, 9), 7)
    mask = torch.ones(2, 9, dtype=torch.bool)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]), torch.no_grad():
        model(ids, mask)
    recs = tracing.spans()
    tracing.clear()
    assert [s.name for s in recs] == ["moe.experts", "moe.experts", "text.decoder"]
    decoder = recs[-1]
    for s in recs[:2]:
        assert s.counts == {"tokens": 18} and s.device_ms is None
        assert decoder.start_ns <= s.start_ns and s.end_ns <= decoder.end_ns


def test_page_vectors_match_the_reference(tiny):
    """Pages of two sizes through ``VisualEmbedder.embed_images`` and
    ``page_vectors`` against the reference's pages and vectors."""
    cfg, pcfg, params, model, reference = tiny
    emb = VisualEmbedder("moonshotai/Kimi-VL-A3B-Instruct", config=pcfg, device="cpu",
                         params={k: v.clone() for k, v in params.items()}, batch_size=2)
    rng = np.random.default_rng(7)
    pages = [rng.integers(0, 256, hw, dtype=np.uint8)
             for hw in ((300, 200, 3), (300, 200, 3), (250, 420, 3))]
    embs, infos = emb.embed_images(pages, return_token_info=True)
    for img, e, info in zip(pages, embs, infos):
        got, payload = page_vectors(emb, e, info)
        page = ref.process_page(img, cfg)
        page["patches"] = page["patches"].astype(np.float16).astype(np.float32)  # the wire
        with torch.no_grad():
            want = ref.page_vectors(reference.page(page, torch.device("cpu")), page)
        assert payload["grid_h_eff"] * payload["grid_w_eff"] == page["n_image_tokens"]
        for name in ("initial", "mean_pooling", "experimental_pooling", "global_pooling"):
            _close(got[name].reshape(want[name].shape), want[name], 1e-4)
