"""The port's ingest path against the JAX package, on the CPU.

- Processor and tokenizer: the port's copies give byte-identical patches,
  masks, ids, segment ids and positions, and equal token infos, for the
  ColSmol, ColPali and ColQwen geometries, and the same query ids.
- Poolings: the ColSmol poolings equal ``visual_rag_tpu.ops.pooling`` at
  1e-6 (numpy on both sides); the experimental-vector plans are equal.
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


@pytest.fixture(scope="module")
def embedders():
    jax_emb = JaxEmbedder("vidore/colSmol-500M", config=_cfg(J.ColVLMConfig), batch_size=6)
    params = jax.tree.map(np.asarray, jax_emb.params)
    cfg = _cfg(P.ColVLMConfig)
    port = VisualEmbedder("vidore/colSmol-500M", config=cfg, batch_size=6,
                          params=params_from_flax(params, cfg), device="cpu")
    return jax_emb, port


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
    with pytest.raises(NotImplementedError, match="colpali"):
        VisualEmbedder("vidore/colpali-v1.3", device="cpu")
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
