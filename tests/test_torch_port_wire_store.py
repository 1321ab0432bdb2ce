"""Port (visual_rag_tpu_torch) vs the JAX package: imports, query wire, stores.

- Importing every port module (the embedding path's included) loads no jax
  (checked in a fresh process).
- The port's numpy query wire is byte-identical to retrieval/batch.py's.
- ``sealed_from_numpy`` of a sealed JAX index holds the same bytes, in f32
  and bf16; the port's ``synthetic_index`` has the JAX one's layout.
- ``chip_smoke.py`` refuses to run without a CUDA device.
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visual_rag_tpu.index import CollectionSchema, IndexBuilder
from visual_rag_tpu.index.manifest import Manifest as JaxManifest
from visual_rag_tpu.index.synth import synthetic_index as jax_synthetic_index
from visual_rag_tpu.retrieval import batch as B
from visual_rag_tpu_torch.index.convert import sealed_from_numpy
from visual_rag_tpu_torch.index.manifest import Manifest
from visual_rag_tpu_torch.index.store import (
    PaddedMultiVectors,
    RaggedMultiVectors,
    SingleVectors,
)
from visual_rag_tpu_torch.index.synth import synthetic_index
from visual_rag_tpu_torch.retrieval import wire

torch.set_num_threads(1)  # tier-1 runs several test workers at once

ROOT = Path(__file__).resolve().parent.parent
DIM = 128


def _queries(n, seed=0, lo=1, hi=40):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((int(rng.integers(lo, hi)), DIM)).astype(np.float32)
            for _ in range(n)]


def test_port_imports_no_jax():
    mods = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "visual_rag_tpu_torch").rglob("*.py"))
    code = ("import importlib, sys\n"
            f"for m in {mods!r}:\n    importlib.import_module(m)\n"
            "assert 'jax' not in sys.modules, 'jax was imported'\n"
            "assert not [m for m in sys.modules if m.split('.')[0] == 'visual_rag_tpu']\n"
            "print(len(sys.modules))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert len(mods) >= 38
    assert {"visual_rag_tpu_torch.models.embedder", "visual_rag_tpu_torch.models.colvlm",
            "visual_rag_tpu_torch.ops.kernels.flash_attention", "visual_rag_tpu_torch.ops.pooling",
            "visual_rag_tpu_torch.index.builder",
            "visual_rag_tpu_torch.pipeline.vectors"} <= set(mods)


def test_chip_smoke_refuses_without_cuda():
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=ROOT, capture_output=True,
                         text=True, timeout=120, env={"CUDA_VISIBLE_DEVICES": "",
                                                      "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0
    assert "needs a CUDA device" in out.stderr
    assert '"ok": true' not in out.stdout


@pytest.mark.parametrize("b", [0, 1, 5, 31, 32, 64, 96])
def test_pad_queries_raw_bytes_match(b):
    qs = _queries(b, seed=b)
    want = [np.asarray(a) for a in B.pad_queries_raw(qs, DIM)]
    got = wire.pad_queries_raw(qs, DIM)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("b", [0, 1, 5, 31, 32, 64, 96])
def test_pack_queries_grouped_bytes_match(b):
    qs = _queries(b, seed=100 + b)
    (want, nq_w, rg_w) = B.pack_queries_grouped(qs, DIM)
    (got, nq, rg) = wire.pack_queries_grouped(qs, DIM)
    assert (nq, rg) == (nq_w, rg_w)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def test_pack_queries_grouped_refuses_ragged_groups_like_jax():
    qs = _queries(40)
    with pytest.raises(ValueError, match="divisible"):
        B.pack_queries_grouped(qs, DIM)
    with pytest.raises(ValueError, match="divisible"):
        wire.pack_queries_grouped(qs, DIM)


def _jax_sealed(storage_dtype):
    rng = np.random.default_rng(7)
    b = IndexBuilder(CollectionSchema.standard(storage_dtype=storage_dtype))
    for i in range(12):
        t = rng.standard_normal((int(rng.integers(3, 70)), DIM)).astype(np.float32)
        pooled = rng.standard_normal((int(rng.integers(1, 5)), DIM)).astype(np.float32)
        b.add(f"p{i}", {"initial": t, "mean_pooling": pooled,
                        "experimental_pooling": pooled[:1],
                        "global_pooling": t.mean(axis=0)}, {"page": i})
    return b.seal()


def _numpy_stores(idx):
    out = {}
    for name, s in idx.stores.items():
        if hasattr(s, "flat"):
            out[name] = {"flat": np.asarray(s.flat), "offsets": np.asarray(s.offsets),
                         "lengths": np.asarray(s.lengths), "max_len": s.max_len}
        elif hasattr(s, "mask"):
            out[name] = {"values": np.asarray(s.values), "mask": np.asarray(s.mask)}
        else:
            out[name] = {"values": np.asarray(s.values)}
    return out


def _bits(t: torch.Tensor) -> bytes:
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    return t.numpy().tobytes()


@pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16"])
def test_sealed_from_numpy_keeps_bytes(storage_dtype):
    jidx = _jax_sealed(storage_dtype)
    arrs = _numpy_stores(jidx)
    idx = sealed_from_numpy(arrs, jidx.manifest.ids, jidx.manifest.payloads,
                            storage_dtype, "cpu")
    assert idx.num_docs == jidx.num_docs == 12
    assert idx.manifest.ids == jidx.manifest.ids
    assert idx.manifest.payload(3) == {"page": 3}
    for name, js in jidx.stores.items():
        ps = idx.store(name)
        if isinstance(ps, RaggedMultiVectors):
            assert ps.max_len == js.max_len
            assert ps.offsets.dtype == ps.lengths.dtype == torch.int32
            assert _bits(ps.flat) == np.asarray(js.flat).tobytes()
            assert ps.offsets.numpy().tobytes() == np.asarray(js.offsets).tobytes()
            assert ps.lengths.numpy().tobytes() == np.asarray(js.lengths).tobytes()
        elif isinstance(ps, PaddedMultiVectors):
            assert _bits(ps.values) == np.asarray(js.values).tobytes()
            assert ps.mask.numpy().tobytes() == np.asarray(js.mask).tobytes()
        else:
            assert isinstance(ps, SingleVectors)
            assert _bits(ps.values) == np.asarray(js.values).tobytes()
        assert ps.storage_dtype == str(np.asarray(js.flat if hasattr(js, "flat")
                                                  else js.values).dtype)


def test_sealed_from_numpy_refuses_int8():
    """int8 codes come across only with their scales: this helper drops
    them, and the conversion refuses every store it left without
    (``tests/test_torch_port_int8.py`` carries whole int8 indexes)."""
    jidx = _jax_sealed("int8")
    arrs = _numpy_stores(jidx)
    for name in arrs:
        with pytest.raises(ValueError, match=f"store '{name}' holds int8 codes"):
            sealed_from_numpy({name: arrs[name]}, jidx.manifest.ids, jidx.manifest.payloads,
                              "int8", "cpu")
    arrs["initial"]["scales"] = np.asarray(jidx.store("initial").scales)
    idx = sealed_from_numpy({"initial": arrs["initial"]}, jidx.manifest.ids,
                            jidx.manifest.payloads, "int8", "cpu")
    assert idx.store("initial").scales.numpy().tobytes() == arrs["initial"]["scales"].tobytes()


@pytest.mark.parametrize("storage_dtype", ["float32", "bfloat16"])
def test_synthetic_index_layout_matches_jax(storage_dtype):
    kw = dict(min_tokens=5, max_tokens=70, pooled_rows=3, storage_dtype=storage_dtype, seed=9)
    j = jax_synthetic_index(40, **kw)
    p = synthetic_index(40, device="cpu", **kw)
    jr, pr = j.store("initial"), p.store("initial")
    np.testing.assert_array_equal(pr.lengths.numpy(), np.asarray(jr.lengths))
    np.testing.assert_array_equal(pr.offsets.numpy(), np.asarray(jr.offsets))
    assert pr.flat.shape == jr.flat.shape and pr.max_len == jr.max_len
    assert pr.storage_dtype == storage_dtype
    assert sorted(p.stores) == sorted(j.stores)
    for name in ("mean_pooling", "experimental_pooling", "global_pooling"):
        assert tuple(p.store(name).values.shape) == tuple(j.store(name).values.shape)
    assert p.manifest.ids == j.manifest.ids
    norms = torch.linalg.vector_norm(pr.flat.float(), dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms), rtol=0, atol=1e-2)
    assert jnp.dtype(j.store("global_pooling").values.dtype) == jnp.float32
    assert p.store("global_pooling").values.dtype == torch.float32


def test_synthetic_index_fills_in_chunks():
    a = synthetic_index(30, min_tokens=5, max_tokens=40, pooled_rows=2,
                        storage_dtype="float32", seed=1, device="cpu")
    b = synthetic_index(30, min_tokens=5, max_tokens=40, pooled_rows=2,
                        storage_dtype="float32", seed=1, device="cpu", chunk_rows=7)
    assert a.store("initial").flat.shape == b.store("initial").flat.shape
    assert torch.isfinite(b.store("initial").flat).all()


def test_device_is_never_picked_silently():
    with pytest.raises(ValueError, match="explicitly"):
        synthetic_index(4, device=None)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            synthetic_index(4, device="cuda")


def test_manifest_payload_plane_matches_jax():
    """Interned payload columns, id lookups, id masks and the version counter
    of the port's manifest equal the JAX manifest's on the same points."""
    ids = [f"p{i}" for i in range(12)]
    payloads = [{"year": 2020 + i % 3, "source": "ab"[i % 2]} if i % 5 else {"year": 2021}
                for i in range(12)]
    jm = JaxManifest()
    for pid, pl in zip(ids, payloads):
        jm.add(pid, pl)
    pm = Manifest(ids, payloads)
    assert (len(pm), pm.version) == (len(jm), jm.version)
    for field in ("year", "source", "missing"):
        (pc, pv), (jc, jv) = pm.payload_index(field), jm.payload_index(field)
        np.testing.assert_array_equal(pc, jc)
        assert pv == jv
    assert "p3" in pm and "zz" not in pm
    assert pm.index_of("p7") == jm.index_of("p7") == 7 and pm.index_of("zz") is None
    np.testing.assert_array_equal(pm.indices_of(["p9", "zz", "p1"]), jm.indices_of(["p9", "zz", "p1"]))
    np.testing.assert_array_equal(pm.id_mask(["p2", "p11", "zz"]), jm.id_mask(["p2", "p11", "zz"]))
    pm.add("late", {"year": 2020})
    codes, vocab = pm.payload_index("year")  # rebuilt after the append
    assert pm.version == jm.version + 1 and codes[-1] == vocab[2020] and len(codes) == 13
    with pytest.raises(ValueError, match="Duplicate"):
        pm.add("p0")
