"""The port's ColVLM against the flax ColVLM, on the CPU.

A ColSmol-shaped tiny config (pixel shuffle 2, attention biases in the
vision tower, no connector bias, a projection bias; the tiny widths, 64
hidden) is initialized in JAX and its parameters carried to the port with
``params_from_flax``. Both sides then run the same numpy inputs:

- modules in f32 at 1e-5: ``RMSNorm``, ``_rope``, ``ViTBlock`` (per-tile
  segments), ``DecoderBlock`` (causal, pads at the end) and the vision tower
  with the pixel shuffle and the connector. The JAX blocks run their dense
  attention on the CPU, which lets a pad query average every key; K10 lets
  it attend the pads. So the blocks compare valid rows only.
- the whole model in f32 at 1e-4 (queries and pages of two sizes in one
  batch, pads included: the projection zeroes them on both sides), and in
  bf16 by per-token cosine >= 0.999 (0.99994 on these inputs: the two
  frameworks round bf16 at different places, XLA fusing some steps).
- tiles stay isolated through the tower; the configs the port does not run
  yet (MoE, scanned layers, ring attention, an unknown MLP activation) are
  refused by name (``remat`` runs: ``tests/test_torch_port_train.py``); ``init_params`` draws flax's
  distributions, with zeros for Gemma's offset norm scales.

ColPali: a ColPali-shaped tiny config that keeps both real head dims (vision
hidden 144, 2 heads: Dh 72; Gemma text hidden 512, 2 heads on 1 kv head: Dh
256; 2 layers each; ``rms_offset``, ``embed_scale``, GeGLU, ``causal=False``,
biased connector and projection) against the flax model the same way:
``RMSNorm(offset=True)``, the GeGLU MLP, a Gemma ``DecoderBlock`` and the
vision tower without the shuffle (learned ``pos[:n]``, no windows, pads) in
f32 at 1e-5; pages (with pad rows) and queries in f32 at 1e-4, and in bf16
by per-token cosine >= 0.999 (0.99992 on these inputs; the embedding scale
rounds its factor to bf16 on both sides).

ColQwen2.5: a ColQwen-shaped tiny config that keeps both real head dims
(vision hidden 160, 2 heads: Dh 80; Qwen2.5 text hidden 256, 2 heads on 1 kv
head: Dh 128 with ColQwen2.5's M-RoPE sections (16, 24, 24)), spatial merge
2, window segments with a full-attention layer among window layers, RMS-normed
gated vision blocks with biases, q/k/v biases in the text model; its pages
come from the processor (two aspect ratios in one batch, so one is padded):
``_rope`` with M-RoPE sections, ``_rope_2d``, the vision block with window
segments, the ``PatchMerger`` and the vision tower with the merger in f32 at
1e-5; ``_mrope_positions`` bit-equal on pages with pads and on queries; pages
and queries through the whole model in f32 at 1e-5 and in bf16 by per-token
cosine >= 0.999; ``init_params`` for the new parameters and the full
ColQwen2.5-v0.2's parameter count.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_rag_tpu.models import colvlm as J
from visual_rag_tpu_torch.models import colvlm as P
from visual_rag_tpu_torch.models.convert import build_model, init_params, params_from_flax

torch.set_num_threads(1)  # tier-1 runs several test workers at once

TILE = 256  # patches a tile at pixel shuffle 2: (8 * 2) ** 2


def _cfg(cls, dtype="float32"):
    tiny = cls.tiny()
    return dataclasses.replace(
        tiny, dtype=dtype, proj_bias=True, connector_bias=False,
        vision=dataclasses.replace(tiny.vision, pixel_shuffle=2, max_patches=2048,
                                   attn_bias=True))


def _page_inputs(cfg, seed=0):
    """Two pages in one batch: 3 tiles, and 2 tiles padded to 3; their ids
    hold 192 and 128 image slots, a prompt, then pads."""
    rng = np.random.default_rng(seed)
    n = 3 * TILE
    patches = rng.random((2, n, cfg.vision.patch_pixels), dtype=np.float32)
    pmask = np.ones((2, n), bool)
    pmask[1, 2 * TILE:] = False
    patches[1, 2 * TILE:] = 0.0
    wids = np.repeat(np.arange(3, dtype=np.int32), TILE)[None].repeat(2, 0)
    wids[1, 2 * TILE:] = -1
    ids = rng.integers(4, cfg.text.vocab, (2, 256)).astype(np.int32)
    ids[0, :192] = cfg.image_token_id
    ids[1, :128] = cfg.image_token_id
    amask = np.zeros((2, 256), bool)
    amask[0, :197], amask[1, :133] = True, True
    return ids, amask, patches, pmask, wids


@pytest.fixture(scope="module")
def models():
    """(JAX model, its params, the port's f32 model with them)."""
    cfg_j = _cfg(J.ColVLMConfig)
    model = J.ColVLM(cfg_j)
    n = TILE  # parameter shapes do not depend on the input's length
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.ones((1, 72), jnp.int32),
                                 jnp.ones((1, 72), bool), jnp.ones((1, n, 48)),
                                 jnp.ones((1, n), bool), jnp.zeros((1, n), jnp.int32))
    params = jax.tree.map(np.asarray, params)
    cfg_p = _cfg(P.ColVLMConfig)
    port = build_model(cfg_p, params_from_flax(params, cfg_p), "cpu")
    return model, params, port


def _t(x):
    return torch.from_numpy(np.array(x))


def test_rmsnorm_matches():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 64)).astype(np.float32)
    scale = rng.standard_normal(64).astype(np.float32)
    want = J.RMSNorm().apply({"params": {"scale": jnp.asarray(scale)}}, jnp.asarray(x))
    norm = P.RMSNorm(64)
    norm.load_state_dict({"scale": _t(scale)})
    np.testing.assert_allclose(norm(_t(x)).detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("theta", [10000.0, 100000.0])
def test_rope_matches(theta):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 40, 3, 16)).astype(np.float32)
    pos = np.stack([np.arange(40), np.maximum(np.arange(40) - 7, 0)]).astype(np.int32)
    want = np.asarray(J._rope(jnp.asarray(x), jnp.asarray(pos), theta))
    np.testing.assert_allclose(P._rope(_t(x), _t(pos), theta).numpy(), want, rtol=0, atol=1e-5)


def test_vit_block_matches(models):
    _, params, port = models
    cfg = _cfg(J.ColVLMConfig).vision
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 2 * TILE, 64)).astype(np.float32)
    mask = np.ones((2, 2 * TILE), bool)
    mask[1, 300:] = False
    segs = np.repeat(np.arange(2, dtype=np.int32), TILE)[None].repeat(2, 0)
    block = J.ViTBlock(cfg, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, *a: block.apply(p, *a[:2], segments=a[2]))(
        {"params": params["params"]["vision"]["block_0"]}, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(segs)))
    got = port.vision.blocks[0](_t(x), _t(mask), segments=_t(segs)).detach().numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)


def test_decoder_block_matches(models):
    _, params, port = models
    cfg = _cfg(J.ColVLMConfig).text
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 50, 64)).astype(np.float32)
    mask = np.ones((2, 50), bool)
    mask[0, 41:] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    want = np.asarray(jax.jit(J.DecoderBlock(cfg, dtype=jnp.float32).apply)(
        {"params": params["params"]["layer_0"]}, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(pos)))
    got = port.layers[0](_t(x), _t(mask), _t(pos)).detach().numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)


def test_vision_tower_and_pixel_shuffle_match(models):
    model, params, port = models
    _, _, patches, pmask, wids = _page_inputs(model.cfg, seed=5)
    encode = jax.jit(lambda p, *x: model.apply(p, *x, method=J.ColVLM.encode_images))
    want = np.asarray(encode(params, jnp.asarray(patches), jnp.asarray(pmask), jnp.asarray(wids)))
    got = port.encode_images(_t(patches), _t(pmask), _t(wids)).detach().numpy()
    assert got.shape == want.shape == (2, 3 * 64, 64)
    # page 1's third tile is padding: its tokens differ (pad attention), unread
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got[1, :128], want[1, :128], rtol=0, atol=1e-5)


def test_whole_model_matches_in_f32(models):
    model, params, port = models
    ids, amask, patches, pmask, wids = _page_inputs(model.cfg, seed=6)
    apply = jax.jit(model.apply)
    want = np.asarray(apply(params, *(jnp.asarray(x) for x in (ids, amask, patches, pmask,
                                                               wids))))
    with torch.inference_mode():
        got = port.embed_pages(*(_t(x) for x in (ids, amask, patches, pmask, wids))).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 256, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    assert not got[~amask].any()
    q_ids = ids[:, 192:204].copy()
    q_mask = np.ones_like(q_ids, bool)
    q_mask[1, 9:] = False
    want_q = np.asarray(apply(params, jnp.asarray(q_ids), jnp.asarray(q_mask)))
    with torch.inference_mode():
        got_q = port.embed_queries(_t(q_ids), _t(q_mask)).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=1e-4)


def test_whole_model_in_bf16_by_cosine(models):
    _, params, _ = models
    cfg_j, cfg_p = _cfg(J.ColVLMConfig, "bfloat16"), _cfg(P.ColVLMConfig, "bfloat16")
    ids, amask, patches, pmask, wids = _page_inputs(cfg_j, seed=7)
    want = np.asarray(jax.jit(J.ColVLM(cfg_j).apply)(params, *(jnp.asarray(x) for x in (
        ids, amask, patches.astype(np.float16), pmask, wids))))
    port = build_model(cfg_p, params_from_flax(params, cfg_p), "cpu")
    assert port.proj.weight.dtype == torch.bfloat16
    assert port.final_norm.scale.dtype == torch.float32
    with torch.inference_mode():
        got = port.embed_pages(_t(ids), _t(amask), _t(patches.astype(np.float16)), _t(pmask),
                               _t(wids)).numpy()
    cos = (got * want).sum(-1)[amask]  # both sides L2-normalized
    assert cos.min() >= 0.999, cos.min()


def test_tiles_are_isolated_through_the_tower(models):
    _, _, port = models
    _, _, patches, pmask, wids = _page_inputs(port.cfg, seed=8)
    with torch.inference_mode():
        base = port.encode_images(_t(patches), _t(pmask), _t(wids))
        pert = patches.copy()
        pert[0, 10] += 3.0  # a patch of tile 0
        out = port.encode_images(_t(pert), _t(pmask), _t(wids))
    torch.testing.assert_close(out[0, 64:], base[0, 64:], rtol=0, atol=0)
    assert (out[0, :64] - base[0, :64]).abs().max() > 1e-4


def test_tile_position_ids_have_the_bucketing_quirk():
    ids = P.tile_position_ids(2 * 1024, pixel_shuffle=4)
    first_row = [0, 0] + list(range(1, 31))  # column ids [0, 0, 1, ..., 30]
    assert ids[:32].tolist() == first_row and ids[32:64].tolist() == first_row
    assert ids[64:67].tolist() == [32, 32, 33]
    assert torch.equal(ids[:1024], ids[1024:])


def _text_field(base, **kw):
    """``base()`` with fields of its text config set."""
    def make():
        cfg = base()
        return dataclasses.replace(cfg, text=dataclasses.replace(cfg.text, **kw))
    return make


@pytest.mark.parametrize("make,field", [
    (_text_field(P.ColVLMConfig.colqwen25_v02, scan_layers=True), "text.scan_layers"),
    (_text_field(P.ColVLMConfig.colqwen25_v02, ring_axis="sp"), "text.ring_axis"),
    (_text_field(P.ColVLMConfig.colqwen25_v02, moe_experts=8), "text.moe_experts"),
    (_text_field(P.ColVLMConfig.colsmol_500m, ring_axis="sp"), "text.ring_axis"),
    (_text_field(P.ColVLMConfig.tiny, moe_experts=4), "text.moe_experts"),
    (_text_field(P.ColVLMConfig.tiny, mlp_act="relu"), "text.mlp_act"),
])
def test_configs_it_does_not_run_are_refused(make, field):
    with pytest.raises(NotImplementedError, match=field.replace(".", r"\.")):
        P.ColVLM(make(), device="meta")


def test_flax_tree_mismatch_is_refused(models):
    _, params, _ = models
    cfg = _cfg(P.ColVLMConfig)
    bad = jax.tree.map(lambda x: x, params)
    del bad["params"]["final_norm"]
    with pytest.raises(ValueError, match="final_norm"):
        params_from_flax(bad, cfg)
    with pytest.raises(ValueError, match="shape"):
        params_from_flax(params, dataclasses.replace(cfg, embed_dim=64))


def test_init_params_draws_flax_distributions():
    cfg = _cfg(P.ColVLMConfig, "bfloat16")
    sd = init_params(cfg, seed=3, device="cpu")
    again = init_params(cfg, seed=3, device="cpu")
    assert all(torch.equal(sd[k], again[k]) for k in sd)
    w = sd["layers.0.mlp.down.weight"]  # fan_in 128
    assert w.dtype == torch.bfloat16 and w.shape == (64, 128)
    assert abs(w.float().std().item() - 128 ** -0.5) < 0.01
    assert w.float().abs().max() <= 2 * 128 ** -0.5 / 0.87962566103423978 + 1e-2
    assert sd["vision.blocks.0.attn.q.bias"].abs().max() == 0
    assert (sd["vision.blocks.0.ln1.scale"] == 1).all()
    assert sd["vision.blocks.0.ln1.scale"].dtype == torch.float32
    assert abs(sd["tok_embed.weight"].float().std().item() - 0.02) < 2e-3
    model = build_model(cfg, sd, "cpu")
    assert sum(p.numel() for p in model.parameters()) == sum(t.numel() for t in sd.values())
    full = P.ColVLM(P.ColVLMConfig.colsmol_500m(), device="meta")
    assert full.vision.pos_embed.shape == (1024, 768)  # the per-tile table of 32 x 32 patches
    assert sum(p.numel() for p in full.parameters()) == 460296512


def test_init_params_zeros_gemmas_offset_norm_scales():
    sd = init_params(_colpali_cfg(P.ColVLMConfig, "bfloat16"), seed=1, device="cpu")
    offset = [k for k in sd if k.startswith("layers.") and ".ln" in k] + ["final_norm.scale"]
    assert len(offset) == 5 and all((sd[k] == 0).all() for k in offset)
    assert (sd["vision.blocks.0.ln1.scale"] == 1).all()  # SigLIP's LayerNorms start at ones
    assert sd["connector.bias"].abs().max() == 0
    # the full ColPali-v1.3 (PaliGemma-3B): jax.eval_shape of the flax init counts the same
    full = P.ColVLM(P.ColVLMConfig.colpali_v13(), device="meta")
    assert sum(p.numel() for p in full.parameters()) == 2943532928
    assert sum(p.numel() for p in full.vision.parameters()) == 432246528
    assert full.tok_embed.weight.numel() == 526778368
    assert full.vision.pos_embed.shape == (1024, 1152)


# -- ColPali ------------------------------------------------------------------

CP_PATCHES = 256  # a 16 x 16 patch page of the tiny ColPali config


def _colpali_cfg(cls, dtype="float32"):
    """ColPali-v1.3's shape at tiny widths, keeping both of its head dims."""
    tiny = cls.tiny()
    return dataclasses.replace(
        tiny, dtype=dtype, proj_bias=True, connector_bias=True, hf_layout="paligemma",
        vision=dataclasses.replace(tiny.vision, hidden=144, heads=2, max_patches=CP_PATCHES,
                                   attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=512, heads=2, kv_heads=1, mlp_hidden=1024,
                                 rope_theta=10000.0, mlp_act="gelu_tanh", rms_offset=True,
                                 embed_scale=True, causal=False, max_seq=512))


def _colpali_page_inputs(cfg, seed=0):
    """Two pages in one batch: 256 and 200 patches (then pads), as many
    image slots, a 4-token prompt, then pad ids."""
    rng = np.random.default_rng(seed)
    patches = rng.random((2, CP_PATCHES, cfg.vision.patch_pixels), dtype=np.float32)
    pmask = np.ones((2, CP_PATCHES), bool)
    pmask[1, 200:] = False
    patches[1, 200:] = 0.0
    ids = rng.integers(4, cfg.text.vocab - 20, (2, 320)).astype(np.int32)
    ids[0, :CP_PATCHES], ids[1, :200] = cfg.image_token_id, cfg.image_token_id
    amask = np.zeros((2, 320), bool)
    amask[0, :260], amask[1, :204] = True, True
    return ids, amask, patches, pmask


@pytest.fixture(scope="module")
def colpali_models():
    """(JAX ColPali-shaped model, its params, the port's f32 model with them)."""
    model = J.ColVLM(_colpali_cfg(J.ColVLMConfig))
    params = jax.jit(model.init)(jax.random.PRNGKey(1), jnp.ones((1, 8), jnp.int32),
                                 jnp.ones((1, 8), bool), jnp.ones((1, CP_PATCHES, 48)),
                                 jnp.ones((1, CP_PATCHES), bool))
    params = jax.tree.map(np.asarray, params)
    # flax starts the offset norms at 0 and the biases at 0: move them, so
    # that the scale's offset and every bias are exercised
    rng = np.random.default_rng(9)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.1, x.shape).astype(x.dtype)
        if path[-1].key in ("scale", "bias") else x, params)
    cfg_p = _colpali_cfg(P.ColVLMConfig)
    return model, params, build_model(cfg_p, params_from_flax(params, cfg_p), "cpu")


def test_offset_rmsnorm_matches():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((2, 5, 512)).astype(np.float32)
    scale = rng.standard_normal(512).astype(np.float32)
    want = J.RMSNorm(offset=True).apply({"params": {"scale": jnp.asarray(scale)}},
                                        jnp.asarray(x))
    norm = P.RMSNorm(512, offset=True)
    norm.load_state_dict({"scale": _t(scale)})
    np.testing.assert_allclose(norm(_t(x)).detach().numpy(), np.asarray(want), rtol=0,
                               atol=1e-5)


def test_geglu_mlp_matches(colpali_models):
    _, params, port = colpali_models
    x = np.random.default_rng(12).standard_normal((2, 7, 512)).astype(np.float32)
    want = J.SwiGLU(1024, dtype=jnp.float32, act="gelu_tanh").apply(
        {"params": params["params"]["layer_1"]["mlp"]}, jnp.asarray(x))
    np.testing.assert_allclose(port.layers[1].mlp(_t(x)).detach().numpy(), np.asarray(want),
                               rtol=0, atol=1e-5)


def test_gemma_decoder_block_matches(colpali_models):
    _, params, port = colpali_models
    cfg = _colpali_cfg(J.ColVLMConfig).text
    rng = np.random.default_rng(13)
    x = rng.standard_normal((2, 70, 512)).astype(np.float32)
    mask = np.ones((2, 70), bool)
    mask[1, 51:] = False
    pos = np.maximum(np.cumsum(mask, axis=1) - 1, 0).astype(np.int32)
    want = np.asarray(jax.jit(J.DecoderBlock(cfg, dtype=jnp.float32).apply)(
        {"params": params["params"]["layer_0"]}, jnp.asarray(x), jnp.asarray(mask),
        jnp.asarray(pos)))
    got = port.layers[0](_t(x), _t(mask), _t(pos)).detach().numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)


def test_colpali_vision_tower_and_connector_match(colpali_models):
    model, params, port = colpali_models
    _, _, patches, pmask = _colpali_page_inputs(model.cfg, seed=14)
    x = np.random.default_rng(15).standard_normal((2, CP_PATCHES, 144)).astype(np.float32)
    block = J.ViTBlock(model.cfg.vision, dtype=jnp.float32)
    want = np.asarray(jax.jit(block.apply)({"params": params["params"]["vision"]["block_1"]},
                                           jnp.asarray(x), jnp.asarray(pmask)))
    got = port.vision.blocks[1](_t(x), _t(pmask)).detach().numpy()
    np.testing.assert_allclose(got[pmask], want[pmask], rtol=0, atol=1e-5)
    encode = jax.jit(lambda p, *a: model.apply(p, *a, method=J.ColVLM.encode_images))
    want = np.asarray(encode(params, jnp.asarray(patches), jnp.asarray(pmask)))
    got = port.encode_images(_t(patches), _t(pmask)).detach().numpy()
    assert got.shape == want.shape == (2, CP_PATCHES, 512)
    np.testing.assert_allclose(got[pmask], want[pmask], rtol=0, atol=1e-5)


def test_colpali_whole_model_matches_in_f32(colpali_models):
    model, params, port = colpali_models
    ids, amask, patches, pmask = _colpali_page_inputs(model.cfg, seed=16)
    apply = jax.jit(model.apply)
    want = np.asarray(apply(params, *(jnp.asarray(x) for x in (ids, amask, patches, pmask))))
    with torch.inference_mode():
        got = port.embed_pages(*(_t(x) for x in (ids, amask, patches, pmask))).numpy()
    assert got.shape == want.shape == (2, 320, 128)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    q_ids = ids[:, 260:284].copy()
    q_mask = np.ones_like(q_ids, bool)
    q_mask[0, 9:] = False
    want_q = np.asarray(apply(params, jnp.asarray(q_ids), jnp.asarray(q_mask)))
    with torch.inference_mode():
        got_q = port.embed_queries(_t(q_ids), _t(q_mask)).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=1e-4)


def test_colpali_whole_model_in_bf16_by_cosine(colpali_models):
    _, params, _ = colpali_models
    cfg_j, cfg_p = _colpali_cfg(J.ColVLMConfig, "bfloat16"), _colpali_cfg(P.ColVLMConfig,
                                                                         "bfloat16")
    ids, amask, patches, pmask = _colpali_page_inputs(cfg_j, seed=17)
    patches = patches.astype(np.float16)
    want = np.asarray(jax.jit(J.ColVLM(cfg_j).apply)(params, *(jnp.asarray(x) for x in (
        ids, amask, patches, pmask))))
    port = build_model(cfg_p, params_from_flax(params, cfg_p), "cpu")
    with torch.inference_mode():
        got = port.embed_pages(_t(ids), _t(amask), _t(patches), _t(pmask)).numpy()
    cos = (got * want).sum(-1)[amask]  # both sides L2-normalized
    assert cos.min() >= 0.999, cos.min()


# -- ColQwen2.5 -----------------------------------------------------------------


def _colqwen_cfg(cls, dtype="float32"):
    """ColQwen2.5-v0.2's shape at tiny widths, keeping both of its head dims
    (vision 160 / 2 = 80, text 256 / 2 = 128 on one kv head) and its M-RoPE
    sections; 3 vision layers, the middle one full attention."""
    real = cls.colqwen25_v02()
    return dataclasses.replace(
        real, dtype=dtype, image_token_id=500,
        vision=dataclasses.replace(real.vision, hidden=160, layers=3, heads=2, mlp_ratio=2.0,
                                   patch_pixels=48, max_patches=1024, full_attn_layers=(1,)),
        text=dataclasses.replace(real.text, hidden=256, layers=2, heads=2, kv_heads=1,
                                 mlp_hidden=512, vocab=512, max_seq=512))


def _colqwen_page_inputs(cfg, seed=0):
    """Two pages of two aspect ratios through the processor, in one batch
    (the smaller one padded): ids, mask, patches, patch mask, window ids,
    patch positions."""
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    rng = np.random.default_rng(seed)
    proc = ImageProcessor(backend="colqwen2.5", image_token_id=cfg.image_token_id,
                          patch_pixels=cfg.vision.patch_pixels, vocab=cfg.text.vocab,
                          max_visual_tokens=cfg.vision.max_patches // 4)
    out = proc.process_images([rng.random((200, 520, 3), dtype=np.float32),  # 10 x 25 cells
                               rng.random((300, 200, 3), dtype=np.float32)])  # 19 x 13
    assert out.patch_mask[1].sum() < out.patch_mask[0].sum() < out.patch_mask.shape[1]
    return (out.input_ids, out.attn_mask, out.patches, out.patch_mask, out.window_ids,
            out.patch_positions)


@pytest.fixture(scope="module")
def colqwen_models():
    """(JAX ColQwen-shaped model, its params, the port's f32 model with them)."""
    model = J.ColVLM(_colqwen_cfg(J.ColVLMConfig))
    params = jax.jit(model.init)(jax.random.PRNGKey(2), jnp.ones((1, 8), jnp.int32),
                                 jnp.ones((1, 8), bool), jnp.ones((1, 64, 48)),
                                 jnp.ones((1, 64), bool))
    params = jax.tree.map(np.asarray, params)
    # flax starts the norm scales at 1 and the biases at 0: move them
    rng = np.random.default_rng(19)
    params = jax.tree_util.tree_map_with_path(
        lambda path, x: x + rng.normal(0, 0.1, x.shape).astype(x.dtype)
        if path[-1].key in ("scale", "bias") else x, params)
    cfg_p = _colqwen_cfg(P.ColVLMConfig)
    return model, params, build_model(cfg_p, params_from_flax(params, cfg_p), "cpu")


def test_mrope_matches():
    rng = np.random.default_rng(20)
    x = rng.standard_normal((2, 40, 3, 128)).astype(np.float32)
    pos = rng.integers(0, 300, (2, 40, 3)).astype(np.int32)
    want = np.asarray(J._rope(jnp.asarray(x), jnp.asarray(pos), 1e6, (16, 24, 24)))
    got = P._rope(_t(x), _t(pos), 1e6, (16, 24, 24)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    # equal axes are 1-D RoPE; 3-D positions without sections use axis 0
    same = np.repeat(pos[..., :1], 3, axis=-1)
    torch.testing.assert_close(P._rope(_t(x), _t(same), 1e6, (16, 24, 24)),
                               P._rope(_t(x), _t(pos[..., 0]), 1e6), rtol=0, atol=0)
    torch.testing.assert_close(P._rope(_t(x), _t(pos), 1e6),
                               P._rope(_t(x), _t(pos[..., 0]), 1e6), rtol=0, atol=0)
    with pytest.raises(ValueError, match="sum"):
        P._rope(_t(x), _t(pos), 1e6, (16, 24, 16))


@pytest.mark.parametrize("dtype", [np.float32, "bfloat16"])
def test_rope_2d_matches(dtype):
    rng = np.random.default_rng(21)
    x = rng.standard_normal((2, 64, 2, 80)).astype(np.float32)
    pos = rng.integers(0, 74, (2, 64, 2)).astype(np.int32)
    jdt = jnp.float32 if dtype == np.float32 else jnp.bfloat16
    want = np.asarray(J._rope_2d(jnp.asarray(x, jdt), jnp.asarray(pos), 10000.0)
                      .astype(jnp.float32))
    tx = _t(x) if dtype == np.float32 else _t(x).to(torch.bfloat16)
    got = P._rope_2d(tx, _t(pos), 10000.0)
    assert got.dtype == tx.dtype
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=1e-5 if dtype == np.float32 else 0)


def test_colqwen_vit_block_matches(colqwen_models):
    model, params, port = colqwen_models
    _, _, _, pmask, wids, ppos = _colqwen_page_inputs(model.cfg, seed=22)
    x = np.random.default_rng(23).standard_normal(pmask.shape + (160,)).astype(np.float32)
    block = J.ViTBlock(model.cfg.vision, dtype=jnp.float32)
    want = np.asarray(jax.jit(lambda p, *a: block.apply(p, *a[:2], segments=a[2],
                                                        positions_2d=a[3]))(
        {"params": params["params"]["vision"]["block_0"]}, jnp.asarray(x), jnp.asarray(pmask),
        jnp.asarray(wids), jnp.asarray(ppos)))
    blk = port.vision.blocks[0]
    assert isinstance(blk.ln1, P.RMSNorm) and blk.mlp.gate.bias is not None
    assert blk.mlp.gate.weight.shape == (320, 160)
    got = blk(_t(x), _t(pmask), segments=_t(wids), positions_2d=_t(ppos)).detach().numpy()
    np.testing.assert_allclose(got[pmask], want[pmask], rtol=0, atol=1e-5)


def test_patch_merger_matches(colqwen_models):
    _, params, port = colqwen_models
    x = np.random.default_rng(24).standard_normal((2, 48, 160)).astype(np.float32)
    want = J.PatchMerger(out_hidden=256, merge=2, dtype=jnp.float32).apply(
        {"params": params["params"]["merger"]}, jnp.asarray(x))
    got = port.merger(_t(x)).detach().numpy()
    assert got.shape == (2, 12, 256)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-5)


def test_colqwen_vision_tower_and_merger_match(colqwen_models):
    model, params, port = colqwen_models
    _, _, patches, pmask, wids, ppos = _colqwen_page_inputs(model.cfg, seed=25)
    encode = jax.jit(lambda p, *a: model.apply(p, *a, method=J.ColVLM.encode_images))
    want = np.asarray(encode(params, *(jnp.asarray(a) for a in (patches, pmask, wids, ppos))))
    got = port.encode_images(*(_t(a) for a in (patches, pmask, wids, ppos))).detach().numpy()
    assert got.shape == want.shape == (2, pmask.shape[1] // 4, 256)
    valid = pmask[:, ::4]  # merged tokens of pad patches differ (pad attention), unread
    assert valid.sum() == 250 + 247
    np.testing.assert_allclose(got[valid], want[valid], rtol=0, atol=1e-5)


def test_mrope_positions_are_bit_equal(colqwen_models):
    model, params, port = colqwen_models
    ids, amask, _, _, _, ppos = _colqwen_page_inputs(model.cfg, seed=26)
    bound = model.bind(params)
    want = np.asarray(bound._mrope_positions(jnp.asarray(ids), jnp.asarray(amask),
                                             jnp.asarray(ppos)))
    got = port._mrope_positions(_t(ids), _t(amask), _t(ppos)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got[amask][:, 1] != got[amask][:, 2]).any()  # image rows differ across axes
    q_mask = amask[:, :20].copy()
    q_mask[1, 13:] = False
    want = np.asarray(bound._mrope_positions(jnp.asarray(ids[:, :20]), jnp.asarray(q_mask),
                                             None))
    np.testing.assert_array_equal(port._mrope_positions(_t(ids[:, :20]), _t(q_mask)).numpy(),
                                  want)


def test_colqwen_whole_model_matches_in_f32(colqwen_models):
    model, params, port = colqwen_models
    inputs = _colqwen_page_inputs(model.cfg, seed=27)
    apply = jax.jit(model.apply)
    want = np.asarray(apply(params, *(jnp.asarray(x) for x in inputs)))
    with torch.inference_mode():
        got = port.embed_pages(*(_t(x) for x in inputs)).numpy()
    ids, amask = inputs[:2]
    assert got.shape == want.shape == ids.shape + (128,)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    q_ids = ids[:, -24:].copy()
    q_ids[:, :4] = np.arange(7, 11)
    q_mask = np.ones_like(q_ids, bool)
    q_mask[0, 17:] = False
    want_q = np.asarray(apply(params, jnp.asarray(q_ids), jnp.asarray(q_mask)))
    with torch.inference_mode():
        got_q = port.embed_queries(_t(q_ids), _t(q_mask)).numpy()
    np.testing.assert_allclose(got_q, want_q, rtol=0, atol=1e-5)


def test_colqwen_whole_model_in_bf16_by_cosine(colqwen_models):
    _, params, _ = colqwen_models
    cfg_j, cfg_p = _colqwen_cfg(J.ColVLMConfig, "bfloat16"), _colqwen_cfg(P.ColVLMConfig,
                                                                         "bfloat16")
    ids, amask, patches, pmask, wids, ppos = _colqwen_page_inputs(cfg_j, seed=28)
    patches = patches.astype(np.float16)
    want = np.asarray(jax.jit(J.ColVLM(cfg_j).apply)(params, *(jnp.asarray(x) for x in (
        ids, amask, patches, pmask, wids, ppos))))
    port = build_model(cfg_p, params_from_flax(params, cfg_p), "cpu")
    assert port.merger.fc1.weight.dtype == torch.bfloat16
    assert port.merger.ln_q.scale.dtype == torch.float32
    with torch.inference_mode():
        got = port.embed_pages(*(_t(x) for x in (ids, amask, patches, pmask, wids, ppos))).numpy()
    cos = (got * want).sum(-1)[amask]  # both sides L2-normalized
    assert cos.min() >= 0.999, cos.min()


def test_init_params_covers_colqwens_parameters():
    sd = init_params(_colqwen_cfg(P.ColVLMConfig, "bfloat16"), seed=2, device="cpu")
    ones = ["merger.ln_q.scale", "final_norm.scale"] + [
        k for k in sd if k.startswith("vision.blocks.") and ".ln" in k]
    assert len(ones) == 8 and all((sd[k] == 1).all() for k in ones)
    biases = [k for k in sd if k.endswith(".bias")]
    assert "merger.fc1.bias" in biases and "vision.blocks.2.mlp.down.bias" in biases
    assert all((sd[k] == 0).all() for k in biases)
    assert "vision.patch_embed.bias" not in sd and "vision.pos_embed" not in sd
    w = sd["merger.fc1.weight"]  # fan_in 640
    assert w.dtype == torch.bfloat16 and abs(w.float().std().item() - 640 ** -0.5) < 0.005
    # the full ColQwen2.5-v0.2: jax.eval_shape of the flax init counts the same
    full = P.ColVLM(P.ColVLMConfig.colqwen25_v02(), device="meta")
    assert sum(p.numel() for p in full.parameters()) == 3963137408
    assert sum(p.numel() for p in full.vision.parameters()) == 840227840
    assert sum(p.numel() for p in full.merger.parameters()) == 36708608
    assert full.tok_embed.weight.numel() == 311164928
    assert full.vision.blocks[0].mlp.up.weight.shape == (5120, 1280)
