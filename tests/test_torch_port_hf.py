"""``params_from_hf`` against live tiny-random HF models, on the CPU.

The models are built in memory, as ``tests/test_torch_forward_parity.py``
builds them for the JAX converter (no download): a PaliGemma
(``PaliGemmaForConditionalGeneration``, the ColPali backbone) and an
Idefics3 (``Idefics3ForConditionalGeneration``, ColSmol's), each with a
random ``custom_text_proj`` head. For each:

- ``params_from_hf`` maps every parameter of the port's model; of the HF
  keys only ``lm_head`` and the SigLIP pooling ``.head.`` stay unused;
- the port's model with those parameters (f32) gives the HF forward's
  last hidden state, projected and L2-normalized, on a page and on a query
  at 2e-5;
- its state dict equals ``params_from_flax(convert_state_dict(...))``, the
  JAX converter's tree carried to the port, tensor for tensor;
- an unknown layout is refused by name, and so is a state dict that lacks a
  tensor.

Qwen2.5-VL (``Qwen2_5_VLForConditionalGeneration``, ColQwen2.5's backbone;
its fused vision ``attn.qkv``, Conv3d patch embed, merger and M-RoPE text
model), as ``tests/test_torch_forward_parity.py`` holds the JAX ColVLM
against it: every key maps (only ``lm_head`` unused, the fused keys consumed
once), the state dict equals the JAX converter's carried across, and the
port's vision tower with the merger (2e-4), page (5e-4) and query (2e-5)
forwards and its M-RoPE positions (bit-equal) match HF's on a 8 x 12 patch
image through the port's processor.
"""

import dataclasses

import numpy as np
import pytest
import torch

transformers = pytest.importorskip("transformers")

from visual_rag_tpu.models import colvlm as J  # noqa: E402
from visual_rag_tpu.models.convert import convert_state_dict  # noqa: E402
from visual_rag_tpu_torch.models import colvlm as P  # noqa: E402
from visual_rag_tpu_torch.models.convert import (  # noqa: E402
    build_model,
    params_from_flax,
    params_from_hf,
)

torch.set_num_threads(1)  # tier-1 runs several test workers at once

EMBED_DIM = 16


def _with_proj(model):
    torch.manual_seed(1)
    sd = dict(model.state_dict())
    sd["custom_text_proj.weight"] = torch.randn(EMBED_DIM, 64) * 0.1
    sd["custom_text_proj.bias"] = torch.randn(EMBED_DIM) * 0.1
    return sd


def _project(h, sd, am):
    e = torch.nn.functional.linear(h, sd["custom_text_proj.weight"], sd["custom_text_proj.bias"])
    e = e / (e.norm(dim=-1, keepdim=True) + 1e-8)
    return (e * torch.tensor(am)[..., None]).numpy()


def _patchify(img_chw, grid, ps):
    """[C, H, W] -> [N, ps*ps*C] patches, row-major, (row, col, channel) flattening."""
    gh, gw = grid
    x = img_chw.transpose(1, 2, 0).reshape(gh, ps, gw, ps, 3).transpose(0, 2, 1, 3, 4)
    return x.reshape(gh * gw, ps * ps * 3)


def _cfgs(**kw):
    """The same ColVLM config in both packages."""
    def make(m):
        return m.ColVLMConfig(
            vision=m.VisionConfig(**kw["vision"]), text=m.TextConfig(**kw["text"]),
            embed_dim=EMBED_DIM, spatial_merge=1, image_token_id=500, dtype="float32",
            proj_bias=True, connector_bias=kw["connector_bias"], hf_layout=kw["hf_layout"])
    return make(J), make(P)


@pytest.fixture(scope="module")
def paligemma():
    from transformers import PaliGemmaConfig, PaliGemmaForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = PaliGemmaConfig(
        vision_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256, patch_size=4, image_size=32, num_channels=3,
                           projection_dim=64),
        text_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=1, intermediate_size=128, vocab_size=512,
                         rope_theta=10000.0, max_position_embeddings=128, head_dim=16,
                         hidden_act="gelu_pytorch_tanh"),
        projection_dim=64, image_token_index=500)
    model = PaliGemmaForConditionalGeneration(hf_cfg).eval().float()
    cfg_j, cfg_p = _cfgs(
        vision=dict(hidden=64, layers=2, heads=4, mlp_ratio=4.0, patch_pixels=48,
                    max_patches=64, attn_bias=True),
        text=dict(hidden=64, layers=2, heads=4, kv_heads=1, mlp_hidden=128, vocab=512,
                  rope_theta=10000.0, max_seq=128, mlp_act="gelu_tanh", rms_offset=True,
                  embed_scale=True, causal=False),
        connector_bias=True, hf_layout="paligemma")
    rng = np.random.default_rng(0)
    px = rng.standard_normal((1, 3, 32, 32)).astype(np.float32)
    page = dict(ids=np.concatenate([np.full(64, 500), np.array([1, 2, 3, 4, 5])])[None],
                hf=dict(pixel_values=torch.tensor(px)), patches=_patchify(px[0], (8, 8), 4))
    return model, _with_proj(model), cfg_j, cfg_p, page


@pytest.fixture(scope="module")
def idefics3():
    from transformers import Idefics3Config, Idefics3ForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = Idefics3Config(
        vision_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                           intermediate_size=256, patch_size=4, image_size=64, num_channels=3),
        text_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, intermediate_size=128, vocab_size=512,
                         rope_theta=100000.0, max_position_embeddings=128, rms_norm_eps=1e-6,
                         tie_word_embeddings=False),
        scale_factor=2, image_token_id=500)
    model = Idefics3ForConditionalGeneration(hf_cfg).eval().float()
    cfg_j, cfg_p = _cfgs(
        vision=dict(hidden=64, layers=2, heads=4, mlp_ratio=4.0, patch_pixels=48,
                    max_patches=256, pixel_shuffle=2, attn_bias=True),
        text=dict(hidden=64, layers=2, heads=4, kv_heads=2, mlp_hidden=128, vocab=512,
                  rope_theta=100000.0, max_seq=128),
        connector_bias=False, hf_layout="idefics3")
    rng = np.random.default_rng(0)
    px = rng.standard_normal((1, 1, 3, 64, 64)).astype(np.float32)
    page = dict(ids=np.concatenate([np.array([1, 2, 3]), np.full(64, 500),
                                    np.array([4, 5])])[None],
                hf=dict(pixel_values=torch.tensor(px),
                        pixel_attention_mask=torch.ones(1, 1, 64, 64, dtype=torch.bool)),
                patches=_patchify(px[0, 0], (16, 16), 4))
    return model, _with_proj(model), cfg_j, cfg_p, page


@pytest.fixture(params=["paligemma", "idefics3"])
def pair(request):
    return request.getfixturevalue(request.param)


def test_every_key_maps(pair):
    _, sd, _, cfg, _ = pair
    got, report = params_from_hf(sd, cfg)
    assert report["missing"] == []
    assert [u for u in report["unused"] if "lm_head" not in u and ".head." not in u] == []
    want = P.ColVLM(cfg, device="meta").state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype for k in want)


def test_page_and_query_forward_match_hf(pair):
    model, sd, _, cfg, page = pair
    port = build_model(cfg, params_from_hf(sd, cfg)[0], "cpu")
    ids, n = page["ids"], page["patches"].shape[0]
    am = np.ones_like(ids)
    with torch.no_grad():
        out = model.model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(am),
                          **page["hf"])
        want = _project(out.last_hidden_state, sd, am)
        got = port.embed_pages(torch.tensor(ids), torch.tensor(am, dtype=torch.bool),
                               torch.from_numpy(page["patches"][None]),
                               torch.ones((1, n), dtype=torch.bool)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)
    q = np.array([[7, 8, 9, 10, 11, 12]])
    qm = np.ones_like(q)
    with torch.no_grad():
        want = _project(model.model(input_ids=torch.tensor(q),
                                    attention_mask=torch.tensor(qm)).last_hidden_state, sd, qm)
        got = port.embed_queries(torch.tensor(q), torch.tensor(qm, dtype=torch.bool)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_state_dict_equals_the_jax_converters(pair):
    _, sd, cfg_j, cfg_p, _ = pair
    got, _ = params_from_hf(sd, cfg_p)
    want = params_from_flax(convert_state_dict(sd, cfg_j)[0], cfg_p)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_numpy_and_bf16_values_convert_like_torch_ones(paligemma):
    """A state dict of numpy arrays (as safetensors' numpy loader gives),
    bf16 ones included, gives the parameters its torch tensors give."""
    import ml_dtypes

    _, sd, _, cfg, _ = paligemma
    want, _ = params_from_hf(sd, cfg)
    got, _ = params_from_hf({k: v.numpy() for k, v in sd.items()}, cfg)
    assert all(torch.equal(got[k], want[k]) for k in want)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    sd16 = {k: v.to(torch.bfloat16) for k, v in sd.items()}
    want, _ = params_from_hf(sd16, cfg16)
    got, _ = params_from_hf({k: v.float().numpy().astype(ml_dtypes.bfloat16)
                             for k, v in sd16.items()}, cfg16)
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert got["layers.0.attn.q.weight"].dtype == torch.bfloat16
    assert got["layers.0.ln1.scale"].dtype == torch.float32


def test_refusals(paligemma):
    _, sd, _, cfg, _ = paligemma
    with pytest.raises(NotImplementedError, match="llava"):
        params_from_hf(sd, dataclasses.replace(cfg, hf_layout="llava"))
    bad = {k: v for k, v in sd.items() if "layers.1.mlp.up_proj" not in k}
    with pytest.raises(ValueError, match="layers.1.mlp.up_proj"):
        params_from_hf(bad, cfg)


# -- Qwen2.5-VL (ColQwen2.5) -------------------------------------------------------

QWEN_GRID = (8, 12)  # pre-merge patch grid of the test image: 4 x 6 merged cells


@pytest.fixture(scope="module")
def qwen():
    from transformers import Qwen2_5_VLConfig, Qwen2_5_VLForConditionalGeneration

    torch.manual_seed(0)
    hf_cfg = Qwen2_5_VLConfig(
        vision_config=dict(depth=2, hidden_size=64, intermediate_size=128, num_heads=4,
                           patch_size=4, temporal_patch_size=2, spatial_merge_size=2,
                           window_size=32, fullatt_block_indexes=[1], out_hidden_size=64,
                           hidden_act="silu", in_channels=3, tokens_per_second=2),
        text_config=dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=4,
                         num_key_value_heads=2, intermediate_size=128, vocab_size=512,
                         rope_theta=1000000.0, max_position_embeddings=128, rms_norm_eps=1e-6,
                         tie_word_embeddings=False,
                         rope_scaling={"type": "mrope", "mrope_section": [2, 3, 3]}),
        image_token_id=500, vision_start_token_id=498, vision_end_token_id=499)
    model = Qwen2_5_VLForConditionalGeneration(hf_cfg).eval().float()

    def make(m):
        return m.ColVLMConfig(
            vision=m.VisionConfig(hidden=64, layers=2, heads=4, mlp_ratio=2.0, patch_pixels=48,
                                  max_patches=4096, window_side=8, full_attn_layers=(1,),
                                  attn_bias=True, mlp_gated=True, rms_norm=True,
                                  patch_bias=False, learned_pos=False, post_ln=False,
                                  rope_2d=True),
            text=m.TextConfig(hidden=64, layers=2, heads=4, kv_heads=2, mlp_hidden=128,
                              vocab=512, rope_theta=1000000.0, max_seq=128,
                              attn_qkv_bias=True, mrope_section=(2, 3, 3)),
            embed_dim=EMBED_DIM, spatial_merge=2, image_token_id=500, dtype="float32",
            proj_bias=True, hf_layout="qwen2.5")

    return model, _with_proj(model), make(J), make(P)


def _qwen_page():
    """One image at the pre-merge grid QWEN_GRID: HF's pixel_values (merge-block
    order, (C, t, row, col) flattened, the image doubled over its 2 frames)
    and the port's processor inputs of the same pixels."""
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    gh, gw, ps = *QWEN_GRID, 4
    canvas = np.random.default_rng(0).standard_normal((gh * ps, gw * ps, 3)).astype(np.float32)
    img = canvas.transpose(2, 0, 1)
    pv = np.stack([img, img]).reshape(2, 3, gh // 2, 2, ps, gw // 2, 2, ps)
    pv = pv.transpose(2, 5, 3, 6, 1, 0, 4, 7).reshape(gh * gw, 3 * 2 * ps * ps)
    n_tok = (gh // 2) * (gw // 2)
    proc = ImageProcessor(backend="colqwen2.5", image_token_id=500, patch_pixels=48, vocab=512,
                          max_visual_tokens=n_tok)
    patches, info = proc._image_tokens_colqwen(canvas, max_tokens=n_tok)
    assert (info["grid_h"], info["grid_w"]) == QWEN_GRID
    ids = np.concatenate([[1, 2, 498], np.full(n_tok, 500), [499, 3, 4]])[None]
    return dict(pv=torch.tensor(pv), thw=torch.tensor([[1, gh, gw]]), ids=ids,
                patches=torch.from_numpy(patches[None]),
                wids=torch.from_numpy(info["_window_ids"][None]),
                ppos=torch.from_numpy(info["_patch_positions"][None]))


def test_qwen_every_key_maps(qwen):
    _, sd, _, cfg = qwen
    got, report = params_from_hf(sd, cfg)
    assert report["missing"] == []
    assert report["unused"] == ["lm_head.weight"]
    want = P.ColVLM(cfg, device="meta").state_dict()
    assert got.keys() == want.keys()
    assert all(got[k].shape == want[k].shape and got[k].dtype == want[k].dtype for k in want)
    qkv = sd["model.visual.blocks.1.attn.qkv.weight"]
    assert torch.equal(got["vision.blocks.1.attn.k.weight"], qkv[64:128])
    conv = sd["model.visual.patch_embed.proj.weight"]  # [64, 3, 2, 4, 4]
    assert torch.equal(got["vision.patch_embed.weight"],
                       conv.sum(dim=2).permute(0, 2, 3, 1).reshape(64, 48))


def test_qwen_state_dict_equals_the_jax_converters(qwen):
    _, sd, cfg_j, cfg_p = qwen
    got, _ = params_from_hf(sd, cfg_p)
    want = params_from_flax(convert_state_dict(sd, cfg_j)[0], cfg_p)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_qwen_vision_tower_matches_hf(qwen):
    model, sd, _, cfg = qwen
    port = build_model(cfg, params_from_hf(sd, cfg)[0], "cpu")
    page = _qwen_page()
    n = page["patches"].shape[1]
    with torch.no_grad():
        want = model.model.visual(page["pv"], grid_thw=page["thw"])
        got = port.encode_images(page["patches"], torch.ones((1, n), dtype=torch.bool),
                                 page["wids"], page["ppos"])[0]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=2e-4)


def test_qwen_page_and_query_forward_match_hf(qwen):
    model, sd, _, cfg = qwen
    port = build_model(cfg, params_from_hf(sd, cfg)[0], "cpu")
    page = _qwen_page()
    ids, n = page["ids"], page["patches"].shape[1]
    am = np.ones_like(ids)
    with torch.no_grad():
        out = model.model(input_ids=torch.tensor(ids), attention_mask=torch.tensor(am),
                          pixel_values=page["pv"], image_grid_thw=page["thw"])
        want = _project(out.last_hidden_state, sd, am)
        got = port.embed_pages(torch.tensor(ids), torch.tensor(am, dtype=torch.bool),
                               page["patches"], torch.ones((1, n), dtype=torch.bool),
                               page["wids"], page["ppos"]).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-4)
    q = np.array([[7, 8, 9, 10, 11]])
    qm = np.ones_like(q)
    with torch.no_grad():
        want = _project(model.model(input_ids=torch.tensor(q),
                                    attention_mask=torch.tensor(qm)).last_hidden_state, sd, qm)
        got = port.embed_queries(torch.tensor(q), torch.tensor(qm, dtype=torch.bool)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-5)


def test_qwen_mrope_positions_match_hf(qwen):
    model, sd, _, cfg = qwen
    port = build_model(cfg, params_from_hf(sd, cfg)[0], "cpu")
    page = _qwen_page()
    am = np.ones_like(page["ids"])
    hf_pos, _ = model.model.get_rope_index(torch.tensor(page["ids"]),
                                           image_grid_thw=page["thw"],
                                           attention_mask=torch.tensor(am))  # [3, B, L]
    got = port._mrope_positions(torch.tensor(page["ids"]), torch.tensor(am, dtype=torch.bool),
                                page["ppos"])
    assert torch.equal(got, hf_pos.permute(1, 2, 0).to(got.dtype))
