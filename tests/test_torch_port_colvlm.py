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
  yet are refused by name; ``init_params`` draws flax's distributions.
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


@pytest.mark.parametrize("make,field", [
    (P.ColVLMConfig.colpali_v13, "text.rms_offset"),
    (P.ColVLMConfig.colqwen25_v02, "text.mrope_section"),
    (lambda: dataclasses.replace(P.ColVLMConfig.tiny(), remat=True), "remat"),
    (lambda: dataclasses.replace(P.ColVLMConfig.tiny(), text=dataclasses.replace(
        P.ColVLMConfig.tiny().text, moe_experts=4)), "text.moe_experts"),
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
