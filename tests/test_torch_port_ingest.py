"""The port's ingest path against the JAX package, on the CPU.

- Processor and tokenizer: the port's copies give byte-identical patches,
  masks, ids, segment ids and positions, and equal token infos, for the
  ColSmol, ColPali and ColQwen geometries, and the same query ids.
- Poolings: the ColSmol and the five ColPali poolings equal
  ``visual_rag_tpu.ops.pooling`` at 1e-6 (numpy on both sides; square and
  non-square grids, windows 1, 3 and 5, the three smoothing kernels); the
  experimental-vector plans are equal.
- ``page_vectors``: the named vectors and token-info payload fields equal
  those the JAX ``ProcessingPipeline._process_single_page`` queues, byte for
  byte, on the same page embedding.
- Embedder: with the JAX tiny ColSmol-shaped model's parameters carried
  across (f32), ``embed_queries`` and ``embed_images(return_token_info=True)``
  equal the JAX ``VisualEmbedder``'s at 1e-4, token infos equal.
- Seal: the port's ``IndexBuilder.seal`` against the JAX one on the same
  vectors. With the JAX package's numpy fallback, every byte is equal
  (scales within an ulp). Where its native library loads, the JAX seal
  normalizes token rows in a C loop that rounds apart from numpy: f32 rows
  then differ by at most 4 ulps on at most half of the elements (3 ulps on
  34% measured), bf16/f16 rows and int8 codes by one step on at most 0.1%,
  int4 residual bytes on at most 0.1%, residual scales within 1e-4
  relative; pooled and single stores stay equal. ``int8``/``int8_refined``
  go through ``quantize_index``.
- The slice end to end: 6 images -> embed -> ``page_vectors`` -> seal ->
  ``two_stage`` and ``single_full`` with embedded queries, on both sides
  (the JAX engine at ``stage1_cut="exact"``): the same ids and scores
  within 1e-5, both when the two engines search the same embeddings and
  when each side searches its own model's.
- ColPali: the same embedder, ``page_vectors`` (``initial``,
  ``mean_pooling``, ``global_pooling``, ``experimental_pooling_3`` and its
  ``experimental_pooling`` alias, sealed under the plan's names) and end-to-end
  checks with a ColPali-shaped tiny config that keeps both real head dims
  (vision Dh 72, Gemma text Dh 256 on one kv head) and ColPali's 32 x 32
  patch grid, parameters carried from the JAX ``VisualEmbedder("vidore/
  colpali-v1.3")``.
- ColQwen2.5: the same with a ColQwen-shaped tiny config that keeps both
  real head dims (vision Dh 80 with window segments and a full-attention
  layer, Qwen2.5 text Dh 128 with M-RoPE), the 2 x 2 PatchMerger, parameters
  carried from the JAX ``VisualEmbedder("vidore/colqwen2.5-v0.2")``: pages
  of two aspect ratios (the processor's patch positions reach the model),
  the adaptive-row mean pooling of the effective grid, ``page_vectors`` with
  the gaussian and triangular vectors and the ``experimental_pooling``
  alias, and the seal and searches end to end. Both ColQwen names map to
  ColQwen2.5-v0.2's config; an embedder refuses a config its model does not
  run when it is built.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from visual_rag_tpu import native
from visual_rag_tpu.index import CollectionSchema as JaxSchema
from visual_rag_tpu.index import IndexBuilder as JaxBuilder
from visual_rag_tpu.models import colvlm as J
from visual_rag_tpu.models.embedder import VisualEmbedder as JaxEmbedder
from visual_rag_tpu.models.processors import ImageProcessor as JaxProcessor
from visual_rag_tpu.ops import pooling as jax_pool
from visual_rag_tpu.pipeline.pipeline import experimental_vector_plan as jax_plan
from visual_rag_tpu.retrieval import RetrievalEngine as JaxEngine
from visual_rag_tpu_torch.index.builder import CollectionSchema, IndexBuilder
from visual_rag_tpu_torch.models import colvlm as P
from visual_rag_tpu_torch.models.convert import params_from_flax
from visual_rag_tpu_torch.models.embedder import VisualEmbedder
from visual_rag_tpu_torch.models.processors import ImageProcessor
from visual_rag_tpu_torch.ops import pooling
from visual_rag_tpu_torch.pipeline.vectors import experimental_vector_plan, page_vectors
from visual_rag_tpu_torch.retrieval.engine import RetrievalEngine
from visual_rag_tpu_torch.retrieval.oracle import strict_rank_equal

torch.set_num_threads(1)  # tier-1 runs several test workers at once

QUERIES = ["what was the revenue in 2021", "chart of sales by region", "a table",
           "who signed the contract on page two"]


def _images(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.random((int(rng.integers(150, 900)), int(rng.integers(150, 900)), 3),
                       dtype=np.float32) for _ in range(n)]


def _cfg(cls):
    tiny = cls.tiny()
    return dataclasses.replace(
        tiny, dtype="float32", proj_bias=True, connector_bias=False,
        vision=dataclasses.replace(tiny.vision, pixel_shuffle=2, max_patches=2048,
                                   attn_bias=True))


def _colpali_cfg(cls):
    """ColPali-v1.3's shape at tiny widths: both real head dims (vision 144 /
    2 heads = 72; text 512 / 2 heads = 256, one kv head), Gemma's pieces,
    a biased connector, and room for ColPali's 32 x 32 patch grid."""
    tiny = cls.tiny()
    return dataclasses.replace(
        tiny, dtype="float32", proj_bias=True, connector_bias=True, hf_layout="paligemma",
        vision=dataclasses.replace(tiny.vision, hidden=144, heads=2, max_patches=1024,
                                   attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=512, heads=2, kv_heads=1, mlp_hidden=512,
                                 rope_theta=10000.0, mlp_act="gelu_tanh", rms_offset=True,
                                 embed_scale=True, causal=False, max_seq=2048))


def _colqwen_cfg(cls):
    """ColQwen2.5-v0.2's shape at tiny widths: vision 160 / 2 heads = 80 with
    8 x 8 patch windows and layer 1 of 3 full, text 256 / 2 heads = 128 on
    one kv head with the M-RoPE sections (16, 24, 24), room for 256 merged
    tokens a page."""
    real = cls.colqwen25_v02()
    return dataclasses.replace(
        real, dtype="float32", image_token_id=500,
        vision=dataclasses.replace(real.vision, hidden=160, layers=3, heads=2, mlp_ratio=2.0,
                                   patch_pixels=48, max_patches=1024, full_attn_layers=(1,)),
        text=dataclasses.replace(real.text, hidden=256, layers=2, heads=2, kv_heads=1,
                                 mlp_hidden=512, vocab=512, max_seq=512))


def _embedder_pair(model_name, cfg_j, cfg_p):
    jax_emb = JaxEmbedder(model_name, config=cfg_j, batch_size=6)
    params = jax.tree.map(np.asarray, jax_emb.params)
    port = VisualEmbedder(model_name, config=cfg_p, batch_size=6,
                          params=params_from_flax(params, cfg_p), device="cpu")
    return jax_emb, port


@pytest.fixture(scope="module")
def embedders():
    return _embedder_pair("vidore/colSmol-500M", _cfg(J.ColVLMConfig), _cfg(P.ColVLMConfig))


@pytest.fixture(scope="module")
def colqwen_embedders():
    return _embedder_pair("vidore/colqwen2.5-v0.2", _colqwen_cfg(J.ColVLMConfig),
                          _colqwen_cfg(P.ColVLMConfig))


@pytest.fixture(scope="module")
def colpali_embedders():
    return _embedder_pair("vidore/colpali-v1.3", _colpali_cfg(J.ColVLMConfig),
                          _colpali_cfg(P.ColVLMConfig))


@pytest.mark.parametrize("backend,patch_pixels,shuffle", [
    ("colsmol", 3 * 16 * 16, 4), ("colsmol", 48, 1), ("colpali", 3 * 14 * 14, 1),
    ("colqwen2.5", 3 * 14 * 14, 1)])
def test_processor_outputs_are_byte_identical(backend, patch_pixels, shuffle):
    kw = dict(backend=backend, image_token_id=500, patch_pixels=patch_pixels, vocab=512,
              max_visual_tokens=1152 if shuffle > 1 else 256, pixel_shuffle=shuffle)
    imgs = _images(1, 3) + [np.full((40, 900), 200.0, np.float32)]  # gray, 0-255
    want = JaxProcessor(**kw).process_images(imgs)
    got = ImageProcessor(**kw).process_images(imgs, pooled=True)
    for name in ("patches", "patch_mask", "input_ids", "attn_mask", "window_ids",
                 "patch_positions"):
        a, b = getattr(got, name), getattr(want, name)
        assert (a is None) == (b is None), name
        if a is not None:
            assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes(), name
    assert got.token_infos == want.token_infos
    ids, mask = ImageProcessor(**kw).process_queries(QUERIES)
    ids_j, mask_j = JaxProcessor(**kw).process_queries(QUERIES)
    assert ids.tobytes() == ids_j.tobytes() and mask.tobytes() == mask_j.tobytes()


def test_poolings_match():
    rng = np.random.default_rng(2)
    for n_tok, tiles in ((13 * 64, 13), (5 * 64, 5), (300, 5), (64, 1)):
        x = rng.standard_normal((n_tok, 128)).astype(np.float32)
        for fn in ("tile_level_mean_pooling", "colsmol_experimental_pooling"):
            want = np.asarray(getattr(jax_pool, fn)(x, tiles))
            got = getattr(pooling, fn)(x, tiles)
            assert got.dtype == np.float32
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(pooling.global_mean_pooling(x),
                                   np.asarray(jax_pool.global_mean_pooling(x)), rtol=0, atol=1e-6)
        assert pooling.global_mean_pooling(x.astype(np.float16)).dtype == np.float16
    for backend in ("colsmol", "colpali", "colqwen2.5"):
        assert experimental_vector_plan(backend, colsmol_2d=True) == jax_plan(
            backend, colsmol_2d=True)


def _close(got, want):
    want = np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("gh,gw", [(32, 32), (7, 7), (12, 20), (40, 9), (1, 6)])
def test_colpali_poolings_match(gh, gw):
    rng = np.random.default_rng(gh * 100 + gw)
    x = rng.standard_normal((gh * gw, 128)).astype(np.float32)
    if gh == gw:
        _close(pooling.colpali_row_mean_pooling(x, grid_size=gh),
               jax_pool.colpali_row_mean_pooling(x, grid_size=gh))
    for target in (32, gh, 5):
        kw = dict(grid_h=gh, grid_w=gw, target_rows=target)
        _close(pooling.adaptive_row_mean_pooling_from_grid(x, **kw),
               jax_pool.adaptive_row_mean_pooling_from_grid(x, **kw))
        _close(pooling.sequence_chunk_mean_pooling(x, target_rows=target),
               jax_pool.sequence_chunk_mean_pooling(x, target_rows=target))
    rows = pooling.adaptive_row_mean_pooling_from_grid(x, grid_h=gh, grid_w=gw, target_rows=gh)
    for window in (1, 3, 5):
        got = pooling.colpali_experimental_pooling_from_rows(rows, window_size=window)
        _close(got, jax_pool.colpali_experimental_pooling_from_rows(rows, window_size=window))
        if gh > 2:
            assert got.shape[0] == gh + 2 * (window // 2)  # 32 rows -> 34 at window 3
        for kernel in ("gaussian", "triangular", "uniform"):
            _close(pooling.weighted_row_smoothing_same_length(rows, window_size=window,
                                                              kernel=kernel),
                   jax_pool.weighted_row_smoothing_same_length(rows, window_size=window,
                                                               kernel=kernel))
    _close(pooling.sequence_chunk_mean_pooling(x.astype(np.float16), 4),  # f16 stays f16
           jax_pool.sequence_chunk_mean_pooling(x.astype(np.float16), 4))
    with pytest.raises(ValueError, match="odd"):
        pooling.colpali_experimental_pooling_from_rows(rows, window_size=4)


def test_embedder_matches(embedders):
    jax_emb, port = embedders
    for got, want in zip(port.embed_queries(QUERIES, batch_size=3),
                         jax_emb.embed_queries(QUERIES, batch_size=3)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    imgs = _images(3, 3)
    got, infos = port.embed_images(imgs, batch_size=2, return_token_info=True)
    want, infos_j = jax_emb.embed_images(imgs, batch_size=2, return_token_info=True)
    assert infos == infos_j
    for g, w, info in zip(got, want, infos):
        assert g.shape == w.shape == (info["num_visual_tokens"] + 4, 128)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        visual = port.extract_visual_embedding(g, info)
        for name in ("mean_pool_visual_embedding", "experimental_pool_visual_embedding"):
            np.testing.assert_allclose(getattr(port, name)(visual, info),
                                       getattr(jax_emb, name)(visual, info), rtol=0, atol=1e-6)


def test_page_vectors_match_the_jax_pipeline(embedders):
    """The vectors and token-info payload fields of ``page_vectors`` equal
    those ``ProcessingPipeline._process_single_page`` queues, on the same
    page embedding."""
    from visual_rag_tpu.pipeline.pipeline import PipelineStats, ProcessingPipeline

    jax_emb, port = embedders
    embs, infos = port.embed_images(_images(6, 2), return_token_info=True)
    pipe = ProcessingPipeline(jax_emb, JaxBuilder(JaxSchema.standard()))
    for i, (e, info) in enumerate(zip(embs, infos)):
        pipe._process_single_page({"page_number": i + 1}, e, info, None, "doc.pdf", {},
                                  PipelineStats())
        want = pipe._queue[-1]
        vectors, payload = page_vectors(port, e, info)
        assert vectors.keys() == want["vectors"].keys()
        for name, v in vectors.items():
            assert v.dtype == np.float32 and v.tobytes() == want["vectors"][name].tobytes(), name
        assert payload == {k: want["payload"][k] for k in payload}


def test_embedder_refuses_other_backends():
    moe = P.ColVLMConfig.colqwen25_v02()
    moe = dataclasses.replace(moe, text=dataclasses.replace(moe.text, moe_experts=8))
    with pytest.raises(NotImplementedError, match=r"text\.moe_experts"):
        VisualEmbedder("vidore/colqwen2.5-v0.2", config=moe, device="cpu")
    with pytest.raises(NotImplementedError, match="checkpoint"):
        VisualEmbedder(checkpoint="some/dir", device="cpu")
    with pytest.raises(ValueError, match="device"):
        VisualEmbedder(device=None)


def _random_points(seed, n):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        tiles = int(rng.integers(2, 8))
        visual = rng.standard_normal((tiles * 64 - int(rng.integers(0, 3)), 128)).astype(np.float32)
        mean = np.asarray(jax_pool.tile_level_mean_pooling(visual, tiles))
        out.append((f"p{i}", {"initial": visual, "mean_pooling": mean,
                              "experimental_pooling": np.asarray(
                                  jax_pool.colsmol_experimental_pooling(visual, tiles)),
                              "global_pooling": mean.mean(axis=0)}, {"year": 2020 + i % 3}))
    return out


def _seal_both(points, dtype):
    port, jx = (IndexBuilder(CollectionSchema.standard(storage_dtype=dtype)),
                JaxBuilder(JaxSchema.standard(storage_dtype=dtype)))
    for pid, vec, pl in points:
        assert port.add(pid, vec, pl) and jx.add(pid, vec, pl)
        assert not port.add(pid, vec, pl)  # skip_existing, as the JAX builder
    assert port.check_exists("p0") and len(port) == len(jx)
    return port.seal(device="cpu"), jx.seal()


def _store_arrays(jst):
    return {k: np.asarray(getattr(jst, k)) for k in ("flat", "offsets", "lengths", "values",
                                                     "mask", "scales", "res4", "res_scales")
            if getattr(jst, k, None) is not None}


def _tensor_numpy(t):
    return t.view(torch.uint16).numpy() if t.dtype == torch.bfloat16 else t.numpy()


def _ulps(g, w):
    """Elementwise distance in units in the last place (codes for ints)."""
    if g.dtype.kind == "f":
        iv = {4: np.int32, 2: np.int16}[g.dtype.itemsize]
        g, w = g.view(iv), w.view(iv)
    return np.abs(g.astype(np.int64) - w.astype(np.int64))


# where the JAX seal uses its native library: the largest distance and the
# largest share of differing elements, per array (bf16 arrays are compared
# as their uint16 bits, res4 as whole bytes)
NATIVE_BOUNDS = {"float32": (4, 0.5), "bfloat16": (1, 1e-3), "float16": (1, 1e-3),
                 "int8": (1, 1e-3), "uint8": (16, 1e-3)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16", "int8", "int8_refined"])
@pytest.mark.parametrize("use_native", [True, False])
def test_seal_matches_the_jax_seal(dtype, use_native, monkeypatch):
    if not use_native:
        monkeypatch.setattr(native, "_lib", None)
        monkeypatch.setattr(native, "_tried", True)
    elif not native.native_available():
        pytest.skip("the JAX native library does not load here")
    got, want = _seal_both(_random_points(4, 12), dtype)
    assert got.storage_dtype == dtype and got.num_docs == want.num_docs == 12
    assert got.manifest.ids == want.manifest.ids
    assert got.manifest.payloads == want.manifest.payloads
    for name, jst in want.stores.items():
        st = got.store(name)
        if hasattr(jst, "max_len"):
            assert st.max_len == jst.max_len
        for key, w in _store_arrays(jst).items():
            g = _tensor_numpy(getattr(st, key))
            w = w.view(np.uint16) if w.dtype.name == "bfloat16" else w.astype(g.dtype)
            assert g.shape == w.shape, (name, key)
            if key == "res_scales" and use_native:  # max|residual| of rows an ulp apart
                np.testing.assert_allclose(g, w, rtol=1e-4, atol=0)
            elif key in ("scales", "res_scales"):
                np.testing.assert_array_max_ulp(g, w, maxulp=1)
            elif not use_native or key in ("offsets", "lengths", "mask"):
                assert g.tobytes() == w.tobytes(), (name, key)
            else:  # the native normalization rounds apart on a share of elements
                most, share = NATIVE_BOUNDS["bfloat16" if g.dtype == np.uint16 else g.dtype.name]
                ulps = _ulps(g, w)
                assert ulps.max() <= most and (ulps > 0).mean() <= share, (
                    name, key, ulps.max(), (ulps > 0).mean())


def test_slice_end_to_end_matches(embedders):
    jax_emb, port = embedders
    imgs = _images(5, 6)
    sides = {}
    for side, emb in (("port", port), ("jax", jax_emb)):
        embs, infos = emb.embed_images(imgs, return_token_info=True)
        sides[side] = (embs, infos, emb.embed_queries(QUERIES))
    def engines(embs, infos):
        b = IndexBuilder(CollectionSchema.standard(storage_dtype="float32"))
        jb = JaxBuilder(JaxSchema.standard(storage_dtype="float32"))
        for i, (e, info) in enumerate(zip(embs, infos)):
            vec, payload = page_vectors(port, e, info)
            assert vec["initial"].shape == (info["num_visual_tokens"], 128)
            assert payload["num_tiles"] == vec["mean_pooling"].shape[0]
            b.add(f"page{i}", vec, payload)
            jb.add(f"page{i}", vec, payload)
        return RetrievalEngine(b.seal(device="cpu")), JaxEngine(jb.seal(), stage1_cut="exact")

    port_eng, _ = engines(*sides["port"][:2])
    _, jax_eng = engines(*sides["jax"][:2])
    same_port, same_jax = engines(*sides["port"][:2])
    for mode, key in (("two_stage", "score_final"), ("single_full", "score")):
        kw = dict(mode=mode, top_k=4, prefetch_k=5, with_payload=False)
        # the same embeddings through both builders and engines: 1e-5
        for a, b in zip(same_port.search_embedded_batch(sides["port"][2], **kw),
                        same_jax.search_embedded_batch(sides["port"][2], **kw)):
            assert strict_rank_equal([dict(h, score=h[key]) for h in b], a, score_tol=1e-5)
        # each side's own model, builder and engine
        for a, b in zip(port_eng.search_embedded_batch(sides["port"][2], **kw),
                        jax_eng.search_embedded_batch(sides["jax"][2], **kw)):
            assert [h["id"] for h in a] == [h["id"] for h in b]
            assert strict_rank_equal([dict(h, score=h[key]) for h in b], a, score_tol=1e-5)


# -- ColPali ------------------------------------------------------------------


def test_colpali_embedder_matches(colpali_embedders):
    jax_emb, port = colpali_embedders
    assert port.backend == "colpali" and port.cfg.text.rms_offset
    for got, want in zip(port.embed_queries(QUERIES, batch_size=3),
                         jax_emb.embed_queries(QUERIES, batch_size=3)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    imgs = _images(13, 3)
    got, infos = port.embed_images(imgs, batch_size=2, return_token_info=True)
    want, infos_j = jax_emb.embed_images(imgs, batch_size=2, return_token_info=True)
    assert infos == infos_j
    for g, w, info in zip(got, want, infos):
        assert info["num_visual_tokens"] == 1024 and g.shape == w.shape == (1028, 128)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        visual = port.extract_visual_embedding(g, info)
        mean = port.mean_pool_visual_embedding(visual, info)
        assert mean.shape == (32, 128)
        np.testing.assert_allclose(mean, jax_emb.mean_pool_visual_embedding(visual, info),
                                   rtol=0, atol=1e-6)
        for kw in ({}, dict(kernel="gaussian"), dict(kernel="triangular", window_size=5),
                   dict(kernel="legacy", window_size=5)):
            np.testing.assert_allclose(
                port.experimental_pool_visual_embedding(visual, info, **kw),
                jax_emb.experimental_pool_visual_embedding(visual, info, **kw), rtol=0,
                atol=1e-6)


def test_colpali_page_vectors_match_the_jax_pipeline(colpali_embedders):
    from visual_rag_tpu.pipeline.pipeline import PipelineStats, ProcessingPipeline

    jax_emb, port = colpali_embedders
    plan = experimental_vector_plan(port.backend)
    assert plan["names"] == ["experimental_pooling_3", "experimental_pooling"]
    embs, infos = port.embed_images(_images(16, 2), return_token_info=True)
    pipe = ProcessingPipeline(jax_emb, JaxBuilder(JaxSchema.standard(
        experimental_names=plan["names"])))
    for i, (e, info) in enumerate(zip(embs, infos)):
        pipe._process_single_page({"page_number": i + 1}, e, info, None, "doc.pdf", {},
                                  PipelineStats())
        want = pipe._queue[-1]
        vectors, payload = page_vectors(port, e, info)
        assert sorted(vectors) == sorted(want["vectors"]) == sorted(
            ["initial", "mean_pooling", "global_pooling"] + plan["names"])
        for name, v in vectors.items():
            assert v.dtype == np.float32 and v.tobytes() == want["vectors"][name].tobytes(), name
        assert vectors["experimental_pooling_3"].shape == (34, 128)
        assert payload == {k: want["payload"][k] for k in payload}


def test_colpali_slice_end_to_end_matches(colpali_embedders):
    jax_emb, port = colpali_embedders
    imgs = _images(15, 6)
    names = experimental_vector_plan("colpali")["names"]
    engines = {}
    for side, emb in (("port", port), ("jax", jax_emb)):
        embs, infos = emb.embed_images(imgs, return_token_info=True)
        builder = (IndexBuilder(CollectionSchema.standard(names, storage_dtype="float32"))
                   if side == "port" else
                   JaxBuilder(JaxSchema.standard(names, storage_dtype="float32")))
        for i, (e, info) in enumerate(zip(embs, infos)):
            builder.add(f"page{i}", *page_vectors(port, e, info))
        engines[side] = ((RetrievalEngine(builder.seal(device="cpu"), stage1_cut="exact")
                          if side == "port" else JaxEngine(builder.seal(), stage1_cut="exact")),
                         emb.embed_queries(QUERIES))
    for mode, key in (("two_stage", "score_final"), ("single_full", "score"),
                      ("single_experimental_pooled", "score")):
        kw = dict(mode=mode, top_k=4, prefetch_k=5, with_payload=False)
        (pe, pq), (je, jq) = engines["port"], engines["jax"]
        for a, b in zip(pe.search_embedded_batch(pq, **kw), je.search_embedded_batch(jq, **kw)):
            assert [h["id"] for h in a] == [h["id"] for h in b]
            assert strict_rank_equal([dict(h, score=h[key]) for h in b], a, score_tol=1e-5)


# -- ColQwen2.5 -------------------------------------------------------------------


def test_both_colqwen_names_take_colqwen25s_config():
    for name, backend in (("vidore/colqwen2.5-v0.2", "colqwen2.5"),
                          ("vidore/colqwen2-v1.0", "colqwen2")):
        emb = VisualEmbedder(name, device="cpu")
        assert emb.backend == backend and emb.cfg == P.ColVLMConfig.colqwen25_v02()
        assert emb.processor.max_visual_tokens == 1024 and emb._model is None


def test_colqwen_embedder_matches(colqwen_embedders):
    jax_emb, port = colqwen_embedders
    assert port.backend == "colqwen2.5" and port.cfg.spatial_merge == 2
    for got, want in zip(port.embed_queries(QUERIES, batch_size=3),
                         jax_emb.embed_queries(QUERIES, batch_size=3)):
        assert got.shape == want.shape and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)
    rng = np.random.default_rng(17)
    imgs = [rng.random((700, 480, 3), dtype=np.float32),  # portrait
            rng.random((420, 820, 3), dtype=np.float32),  # landscape
            rng.random((500, 500, 3), dtype=np.float32)]
    seen = []
    embed_pages = port.model.embed_pages
    port.model.embed_pages = lambda *a: seen.append(a) or embed_pages(*a)
    try:
        got, infos = port.embed_images(imgs, batch_size=2, return_token_info=True)
    finally:
        del port.model.embed_pages
    want, infos_j = jax_emb.embed_images(imgs, batch_size=2, return_token_info=True)
    assert infos == infos_j
    assert len({(i["grid_h_eff"], i["grid_w_eff"]) for i in infos}) == 3
    ppos = JaxProcessor(backend="colqwen2.5", image_token_id=500, patch_pixels=48, vocab=512,
                        max_visual_tokens=256).process_images(imgs[:2]).patch_positions
    assert seen[0][5].dtype == torch.int32 and np.array_equal(seen[0][5].numpy(), ppos)
    for g, w, info in zip(got, want, infos):
        n = info["grid_h_eff"] * info["grid_w_eff"]
        assert info["num_visual_tokens"] == n and g.shape == w.shape == (n + 4, 128)
        np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        visual = port.extract_visual_embedding(g, info)
        mean = port.mean_pool_visual_embedding(visual, info)
        assert mean.shape == (min(32, info["grid_h_eff"]), 128)
        np.testing.assert_allclose(mean, jax_emb.mean_pool_visual_embedding(visual, info),
                                   rtol=0, atol=1e-6)
        for kw in ({}, dict(target_vectors=None), dict(kernel="triangular"),
                   dict(kernel="legacy")):
            np.testing.assert_allclose(
                port.experimental_pool_visual_embedding(visual, info, **kw),
                jax_emb.experimental_pool_visual_embedding(visual, info, **kw), rtol=0,
                atol=1e-6)


def test_colqwen_page_vectors_match_the_jax_pipeline(colqwen_embedders):
    from visual_rag_tpu.pipeline.pipeline import PipelineStats, ProcessingPipeline

    jax_emb, port = colqwen_embedders
    plan = experimental_vector_plan(port.backend)
    assert plan["names"] == ["experimental_pooling_gaussian", "experimental_pooling_triangular",
                             "experimental_pooling"]
    embs, infos = port.embed_images(_images(18, 2), return_token_info=True)
    pipe = ProcessingPipeline(jax_emb, JaxBuilder(JaxSchema.standard(
        experimental_names=plan["names"])))
    for i, (e, info) in enumerate(zip(embs, infos)):
        pipe._process_single_page({"page_number": i + 1}, e, info, None, "doc.pdf", {},
                                  PipelineStats())
        want = pipe._queue[-1]
        vectors, payload = page_vectors(port, e, info)
        assert sorted(vectors) == sorted(want["vectors"]) == sorted(
            ["initial", "mean_pooling", "global_pooling"] + plan["names"])
        for name, v in vectors.items():
            assert v.dtype == np.float32 and v.tobytes() == want["vectors"][name].tobytes(), name
        rows = vectors["mean_pooling"].shape[0]
        assert vectors["experimental_pooling_gaussian"].shape == (rows, 128)
        assert np.array_equal(vectors["experimental_pooling"],
                              vectors["experimental_pooling_gaussian"])
        assert payload == {k: want["payload"][k] for k in payload}


def test_colqwen_slice_end_to_end_matches(colqwen_embedders):
    jax_emb, port = colqwen_embedders
    imgs = _images(19, 6)
    names = experimental_vector_plan("colqwen2.5")["names"]
    engines = {}
    for side, emb in (("port", port), ("jax", jax_emb)):
        embs, infos = emb.embed_images(imgs, return_token_info=True)
        builder = (IndexBuilder(CollectionSchema.standard(names, storage_dtype="float32"))
                   if side == "port" else
                   JaxBuilder(JaxSchema.standard(names, storage_dtype="float32")))
        for i, (e, info) in enumerate(zip(embs, infos)):
            builder.add(f"page{i}", *page_vectors(port, e, info))
        engines[side] = ((RetrievalEngine(builder.seal(device="cpu"), stage1_cut="exact")
                          if side == "port" else JaxEngine(builder.seal(), stage1_cut="exact")),
                         emb.embed_queries(QUERIES))
    for mode, key in (("two_stage", "score_final"), ("single_full", "score"),
                      ("single_experimental_pooled", "score")):
        kw = dict(mode=mode, top_k=4, prefetch_k=5, with_payload=False)
        (pe, pq), (je, jq) = engines["port"], engines["jax"]
        for a, b in zip(pe.search_embedded_batch(pq, **kw), je.search_embedded_batch(jq, **kw)):
            assert [h["id"] for h in a] == [h["id"] for h in b]
            assert strict_rank_equal([dict(h, score=h[key]) for h in b], a, score_tol=1e-5)
