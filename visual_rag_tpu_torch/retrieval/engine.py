"""RetrievalEngine: the batched query planner over a SealedIndex.

Port of ``visual_rag_tpu/retrieval/engine.py``: all eight search modes, the
five stage-1 modes and their deprecated aliases, and payload filters, over
float, int8 and int8_refined stores, through ``search_embedded_batch[es]``,
the per-query ``search_embedded`` (a batch of one through the same plans)
and the ``_dispatch_batch`` / ``_finish_batch`` split that the serving layer
uses (``serving/server.py:195-236`` of the JAX package). ``scan`` on the
padded wire raises.

Policies, as the JAX engine's except where noted:

- constructor: the JAX engine's arguments (``engine.py:279-338``), each with
  the port's meaning. ``compute_dtype`` None resolves to ``"float32"``, as
  the JAX engine's does off the TPU: the plans score in f32, and
  ``"bfloat16"`` is refused. ``rerank_chunk`` is recorded only: K3 and K4
  take any batch in one launch. ``stage1_cut`` ``"auto"`` and ``"exact"``
  both cut exactly; ``"approx"`` is refused. ``wire_dtype`` ``"auto"`` and
  ``"f32"`` give the f32 wire; ``"f16"`` is refused. ``VISUALRAG_QUERY_WIRE``
  and ``VISUALRAG_WIRE_DTYPE`` are read only where the argument is
  ``"auto"`` (``engine.py:314-315, 326-327``). Every refusal is a
  ``ValueError`` naming the declared difference (ROADMAP).
- wire: ``query_wire="auto"`` is the packed wire at B >= 32 on CUDA and the
  padded wire on the CPU (``engine.py:637-639``). The wire is always f32;
  the JAX engine's automatic f16 wire is not inherited (ROADMAP C6).
- rerank (``EngineCommon._rerank_impl``, ``engine.py:149-193``):
  ``retrieval/local.py::rerank_route`` picks it from the bucketed batch
  and K = ``prefetch_k`` for ``two_stage``, ``stage2_k`` for
  ``three_stage``. ``scan`` on the padded wire raises (the JAX engine falls
  back there with a warning).
- stage-1 cut: always exact (the JAX engine's ``approx_max_k`` at >= 65536
  docs is a declared difference, ROADMAP).
- filters: one device mask per (filter signature, manifest version),
  memoised up to 64 masks (``engine.py:367-387``).
- transfers: on a CUDA device a batch never waits for the stream. Its
  query wire is packed into pinned host memory and copied up without
  blocking (``wire.PinnedArrays``); once its last kernel is queued, its
  results are copied into pinned host tensors behind one CUDA event, and
  ``_finish_batch`` waits on that event alone. So
  ``search_embedded_batches(depth=2)`` packs batch n+1 while the card runs
  batch n. On the CPU both are plain numpy. ``transfer_stats`` counts the
  batches dispatched and those that took the pinned path.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from visual_rag_tpu_torch.index.store import (
    PaddedMultiVectors,
    RaggedMultiVectors,
    SealedIndex,
    SingleVectors,
)
from visual_rag_tpu_torch.retrieval import plans, wire
from visual_rag_tpu_torch.retrieval.local import NEG_INF, rerank_route
from visual_rag_tpu_torch.tracing import span

STAGE1_MODES = (
    "pooled_query_vs_standard_pooling",
    "tokens_vs_standard_pooling",
    "pooled_query_vs_experimental_pooling",
    "tokens_vs_experimental_pooling",
    "pooled_query_vs_global",
)

# Deprecated stage-1 aliases (reference two_stage.py:131-139)
_STAGE1_ALIASES = {
    "pooled_query_vs_tiles": "pooled_query_vs_standard_pooling",
    "tokens_vs_tiles": "tokens_vs_standard_pooling",
    "pooled_query_vs_experimental": "pooled_query_vs_experimental_pooling",
    "tokens_vs_experimental": "tokens_vs_experimental_pooling",
}

SEARCH_MODES = (
    "single_full",
    "single_tiles",
    "single_pooled",
    "single_global",
    "single_experimental_tokens",
    "single_experimental_pooled",
    "two_stage",
    "three_stage",
)


class BatchResultArrays:
    """Dense batched results: ``ids`` object [B, K] of manifest ids (None
    where a row has fewer than K hits), ``scores`` [B, K] f32, ``valid``
    [B, K] bool, ``indices`` [B, K] int32 doc indices (-1 invalid).
    ``to_dicts()`` gives the classic list-of-hit-dicts form."""

    __slots__ = ("ids", "scores", "valid", "indices")

    def __init__(self, ids, scores, valid, indices):
        self.ids = ids
        self.scores = scores
        self.valid = valid
        self.indices = indices

    def __len__(self):
        return len(self.ids)

    def to_dicts(self) -> List[List[Dict[str, Any]]]:
        return [
            [{"id": i, "rank": r, "score": s, "score_final": s}
             for r, (i, s, v) in enumerate(zip(row_i, row_s, row_v)) if v]
            for row_i, row_s, row_v in zip(self.ids.tolist(), self.scores.tolist(),
                                           self.valid.tolist())
        ]


class RetrievalEngine:
    """Batched query planner over one sealed collection, on its device."""

    PACKED_MIN_BATCH = 32  # auto wire: packed from this batch bucket (CUDA)
    BATCH_BUCKETS = (1, 2, 4, 8, 16, 32, 64, 128, 256)

    def __init__(
        self,
        index: SealedIndex,
        full_vector_name: str = "initial",
        pooled_vector_name: str = "mean_pooling",
        global_vector_name: str = "global_pooling",
        experimental_vector_name: str = "experimental_pooling",
        compute_dtype: Optional[str] = None,
        rerank_chunk: int = 256,
        stage1_cut: str = "auto",
        rerank_impl: str = "auto",
        query_wire: str = "auto",
        wire_dtype: str = "auto",
    ):
        compute_dtype = "float32" if compute_dtype is None else compute_dtype
        if compute_dtype != "float32":
            raise ValueError(
                f"compute_dtype must be float32 (or None), got {compute_dtype!r}: the port's "
                "plans score in f32; the JAX engine's bf16 scoring on the TPU is a declared "
                "difference")
        if stage1_cut == "approx":
            raise ValueError(
                "stage1_cut='approx' is refused: the port's stage-1 cut is always exact "
                "(lax.approx_max_k is a declared difference)")
        if stage1_cut not in ("auto", "exact"):
            raise ValueError(f"stage1_cut must be auto|exact, got {stage1_cut!r}")
        if rerank_impl not in ("auto", "plain", "dedup", "sweep", "scan"):
            raise ValueError(
                f"rerank_impl must be auto|plain|dedup|sweep|scan, got {rerank_impl!r}")
        # the environment refines the default only: an explicit argument wins
        if query_wire == "auto":
            query_wire = os.environ.get("VISUALRAG_QUERY_WIRE", query_wire)
        if query_wire not in ("auto", "padded", "packed"):
            raise ValueError(f"query_wire must be auto|padded|packed, got {query_wire!r}")
        if wire_dtype == "auto":
            wire_dtype = os.environ.get("VISUALRAG_WIRE_DTYPE", wire_dtype)
        if wire_dtype == "f16":
            raise ValueError(
                "wire_dtype='f16' is refused: the port serves an f32 query wire only (the "
                "JAX engine's f16 wire has no oracle; a declared difference)")
        if wire_dtype not in ("auto", "f32"):
            raise ValueError(f"wire_dtype must be auto|f32, got {wire_dtype!r}")
        self.index = index
        self.full_vector_name = full_vector_name
        self.pooled_vector_name = pooled_vector_name
        self.global_vector_name = global_vector_name
        self.experimental_vector_name = experimental_vector_name
        self.compute_dtype = compute_dtype
        self.rerank_chunk = int(rerank_chunk)  # recorded only: K3 and K4 take any batch
        self.stage1_cut = stage1_cut
        self.rerank_impl = rerank_impl
        self.query_wire = query_wire
        self.wire_dtype = wire_dtype
        self.device = index.device if index.stores else None
        self._arrays: Dict[str, Dict] = {}
        self._ids: Optional[np.ndarray] = None
        self._mask_cache: Dict[Any, torch.Tensor] = {}
        self.transfer_stats = {"batches": 0, "pinned": 0}
        self._stats_lock = threading.Lock()  # search_embedded runs on many threads

    # -- policies --------------------------------------------------------------

    @classmethod
    def _bucket_batch(cls, queries):
        """Pad ``queries`` up to the enclosing batch bucket (above the
        ladder, the next multiple of 256), so the packed wire's groups of 32
        divide every batch from 32 up. Padding rows repeat query 0; callers
        slice results back to ``n_real``. Returns (queries, n_real, b)."""
        n_real = len(queries)
        b = next((c for c in cls.BATCH_BUCKETS if n_real <= c),
                 ((n_real + 255) // 256) * 256)
        if b != n_real:
            queries = list(queries) + [queries[0]] * (b - n_real)
        return queries, n_real, b

    def _use_packed(self, b: int) -> bool:
        if self.query_wire == "auto":
            return self.device.type == "cuda" and b >= self.PACKED_MIN_BATCH
        return self.query_wire == "packed"

    def _fused_stage1(self, stage1_mode: str):
        m = _STAGE1_ALIASES.get(stage1_mode, stage1_mode)
        table = {
            "pooled_query_vs_standard_pooling": ("pooled_padded", self.pooled_vector_name),
            "tokens_vs_standard_pooling": ("tokens_padded", self.pooled_vector_name),
            "pooled_query_vs_experimental_pooling": ("pooled_padded",
                                                     self.experimental_vector_name),
            "tokens_vs_experimental_pooling": ("tokens_padded", self.experimental_vector_name),
            "pooled_query_vs_global": ("pooled_single", self.global_vector_name),
        }
        if m not in table:
            raise ValueError(f"Unknown stage1_mode: {stage1_mode}")
        return table[m]

    def _single_stage(self, mode: str):
        return {
            "single_full": ("tokens_ragged", self.full_vector_name),
            "single_tiles": ("tokens_padded", self.pooled_vector_name),
            "single_pooled": ("pooled_padded", self.pooled_vector_name),
            "single_global": ("pooled_single", self.global_vector_name),
            "single_experimental_tokens": ("tokens_padded", self.experimental_vector_name),
            "single_experimental_pooled": ("pooled_padded", self.experimental_vector_name),
        }[mode]

    def _fused_arrays(self, name: str) -> Dict:
        """Store tensors in the layout the plans take, cached per store
        (JAX ``engine.py:735-754``, ``batch.py:600-634``): int8 ragged and
        padded stores keep their codes with f32 scales beside them (per doc
        ``scales``, the ``res4``/``res_scales`` sidecar; per row ``scales_t``
        [P, D]); an int8 single-vector store is dequantized to f32 once."""
        arr = self._arrays.get(name)
        if arr is None:
            store = self.index.store(name)
            if isinstance(store, RaggedMultiVectors):
                arr = {"flat": store.flat, "offsets": store.offsets,
                       "lengths": store.lengths, "max_len": store.max_len}
                for key in ("scales", "res4", "res_scales"):
                    if getattr(store, key) is not None:
                        arr[key] = getattr(store, key)
            elif isinstance(store, PaddedMultiVectors):
                arr = {"vals_t": store.values.permute(1, 0, 2).contiguous(),
                       "mask_t": store.mask.T.contiguous()}
                if store.scales is not None:
                    arr["scales_t"] = store.scales.T.float().contiguous()
            elif isinstance(store, SingleVectors):
                arr = {"vals": store.dequantized(torch.float32) if store.scales is not None
                       else store.values}
            else:
                raise ValueError(f"store {name!r} has an unknown layout ({store.kind})")
            self._arrays[name] = arr
        return arr

    def _doc_mask(self, filter_obj) -> Optional[torch.Tensor]:
        """[D] bool device mask of a filter (None when unfiltered), memoised
        on (signature, manifest version): a caller that applies one filter
        to many queries evaluates and copies it once. Takes this package's
        ``PayloadFilter`` or the JAX package's (same surface)."""
        if filter_obj is None or filter_obj.is_empty():
            return None
        key = (filter_obj.signature(), self.index.manifest.version)
        mask = self._mask_cache.get(key)
        if mask is None:
            mask = torch.as_tensor(np.asarray(filter_obj.evaluate(self.index.manifest),
                                              dtype=bool)).to(self.device)
            if len(self._mask_cache) >= 64:  # bound the device memory held by masks
                self._mask_cache.pop(next(iter(self._mask_cache)))
            self._mask_cache[key] = mask
        return mask

    # -- public search API -------------------------------------------------------

    def warmup(self, modes: Sequence[str] = ("two_stage",),
               batch_sizes: Sequence[int] = (1, 64), n_query_tokens: int = 24,
               **search_kwargs) -> float:
        """Run each mode once at each batch size on random queries (JAX
        ``engine.py:249-273``): a serving process calls it at startup, so
        that the first real query builds no kernel and finds the store
        layouts cached. Its dim is the full store's. Returns seconds spent."""
        dim = int(self.index.store(self.full_vector_name).dim)
        rng = np.random.default_rng(0)
        t0 = time.time()
        for mode in modes:
            for bs in batch_sizes:
                qs = [rng.standard_normal((n_query_tokens, dim)).astype(np.float32)
                      for _ in range(bs)]
                self.search_embedded_batch(qs, mode=mode, top_k=10, with_payload=False,
                                           **search_kwargs)
        return time.time() - t0

    def search_embedded(self, query_embedding, mode: str = "two_stage", top_k: int = 10,
                        prefetch_k: Optional[int] = None,
                        stage1_mode: str = "pooled_query_vs_standard_pooling",
                        stage1_k: Optional[int] = None, stage2_k: Optional[int] = None,
                        filter_obj=None, with_payload: bool = True) -> List[Dict[str, Any]]:
        """Search with one query embedding [nq, dim] (or [dim]): a batch of
        one through the batched plans (JAX ``engine.py:517-549``)."""
        if mode not in SEARCH_MODES:
            raise ValueError(f"Unknown mode: {mode}. Choose one of {SEARCH_MODES}")
        return self.search_embedded_batch(
            [query_embedding], mode=mode, top_k=top_k, prefetch_k=prefetch_k,
            stage1_mode=stage1_mode, stage1_k=stage1_k, stage2_k=stage2_k,
            filter_obj=filter_obj, with_payload=with_payload)[0]

    def search_embedded_batch(self, query_embeddings, mode: str = "two_stage",
                              top_k: int = 10, prefetch_k: Optional[int] = None,
                              stage1_mode: str = "pooled_query_vs_standard_pooling",
                              stage1_k: Optional[int] = None,
                              stage2_k: Optional[int] = None, filter_obj=None,
                              with_payload: bool = True, return_arrays: bool = False):
        """Batched search: list of [nq_i, dim] queries -> list of hit lists
        (or :class:`BatchResultArrays` with ``return_arrays=True``, which
        requires ``with_payload=False``)."""
        return self._finish_batch(self._dispatch_batch(
            query_embeddings, mode=mode, top_k=top_k, prefetch_k=prefetch_k,
            stage1_mode=stage1_mode, stage1_k=stage1_k, stage2_k=stage2_k,
            filter_obj=filter_obj, with_payload=with_payload,
            return_arrays=return_arrays))

    def search_embedded_batches(self, query_batches, depth: int = 2, **search_kwargs):
        """Pipelined batches: dispatch up to ``depth`` batches ahead before
        fetching batch i's results, which waits for batch i's own copies
        only (on CUDA; see the module docstring). Yields one result per
        batch, in order."""
        depth = max(1, int(depth))
        pend = deque()
        for qb in query_batches:
            pend.append(self._dispatch_batch(qb, **search_kwargs))
            if len(pend) > depth:
                yield self._finish_batch(pend.popleft())
        while pend:
            yield self._finish_batch(pend.popleft())

    def _dispatch_batch(self, query_embeddings, mode: str = "two_stage",
                        top_k: int = 10, prefetch_k: Optional[int] = None,
                        stage1_mode: str = "pooled_query_vs_standard_pooling",
                        stage1_k: Optional[int] = None, stage2_k: Optional[int] = None,
                        filter_obj=None, with_payload: bool = True,
                        return_arrays: bool = False):
        """Queue one batch's device work and, on CUDA, the copies of its
        results to pinned host memory; returns a pending record for
        :meth:`_finish_batch`. Nothing here waits for the device."""
        if mode not in SEARCH_MODES:
            raise ValueError(f"Unknown mode: {mode}. Choose one of {SEARCH_MODES}")
        if return_arrays and with_payload:
            raise ValueError("return_arrays=True requires with_payload=False")
        with span("search.dispatch"):
            d = self.index.num_docs
            if d == 0 or not len(query_embeddings):
                return ("empty", len(query_embeddings), with_payload, return_arrays, {}, None)
            queries, n_real, b = self._bucket_batch(query_embeddings)
            ragged = self._fused_arrays(self.full_vector_name)
            dim = ragged["flat"].shape[1]
            packed = self._use_packed(b)
            pinned = wire.PinnedArrays() if self.device.type == "cuda" else None
            alloc = pinned or np.empty
            if packed:
                arrays, nq, _ = wire.pack_queries_grouped(queries, dim, alloc=alloc)
                q1, q2, q3 = wire.to_device(arrays, self.device, pinned)
            else:
                arrays = wire.pad_queries_raw(queries, dim, alloc=alloc)
                q1, q2 = wire.to_device(arrays, self.device, pinned)
                q3, nq = None, arrays[0].shape[1]
            with self._stats_lock:
                self.transfer_stats["batches"] += 1
                self.transfer_stats["pinned"] += pinned is not None
            doc_mask = self._doc_mask(filter_obj)
            common = dict(wire="packed" if packed else "padded", b=b, nq=nq)

            if mode.startswith("single_"):
                kind, name = self._single_stage(mode)
                vals, idx = plans.single_plan(
                    self._fused_arrays(name), ragged, doc_mask, q1, q2, q3, kind=kind,
                    k=max(1, min(int(top_k), d)), **common)
                return self._pending(n_real, with_payload, return_arrays,
                                     {"idx": idx, "score": vals})

            if mode == "two_stage":
                if prefetch_k is None:
                    prefetch_k = max(100, top_k * 10)  # reference default (two_stage.py:128-129)
                kind, name = self._fused_stage1(stage1_mode)
                pk = max(1, min(int(prefetch_k), d))
                vals, idx = plans.two_stage_plan(
                    self._fused_arrays(name), ragged, doc_mask, q1, q2, q3, kind=kind, pk=pk,
                    k=max(1, min(int(top_k), pk)),
                    impl=rerank_route(ragged, d, b, pk, packed, self.rerank_impl), **common)
                return self._pending(n_real, with_payload, return_arrays,
                                     {"idx": idx, "score_stage2": vals, "score_final": vals})

            s1k = max(1, min(int(stage1_k or 1000), d))
            s2k = max(1, min(int(stage2_k or 300), d))
            vals, idx, s1_at, s2_at = plans.three_stage_plan(
                self._fused_arrays(self.global_vector_name),
                self._fused_arrays(self.experimental_vector_name), ragged, doc_mask, q1, q2, q3,
                s1k=s1k, s2k=s2k, k=max(1, min(int(top_k), s2k)),
                impl=rerank_route(ragged, d, b, s2k, packed, self.rerank_impl), **common)
            return self._pending(n_real, with_payload, return_arrays,
                                 {"idx": idx, "score_stage3": vals, "score_final": vals,
                                  "score_stage1": s1_at, "score_stage2": s2_at})

    def _pending(self, n_real, with_payload, return_arrays, results):
        """The pending record of a queued batch. On CUDA, its results' copies
        into pinned host tensors are queued on the current stream behind the
        batch's kernels, and one event marks them done."""
        if self.device.type != "cuda":
            return ("done", n_real, with_payload, return_arrays, results, None)
        host = {}
        for k, v in results.items():
            host[k] = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            host[k].copy_(v, non_blocking=True)
        ready = torch.cuda.Event()
        ready.record(torch.cuda.current_stream(self.device))
        return ("done", n_real, with_payload, return_arrays, host, ready)

    def _finish_batch(self, pending):
        tag, n_real, with_payload, return_arrays, arrays, ready = pending
        with span("search.finish"):
            if tag == "empty":
                if return_arrays:
                    z = np.zeros((n_real, 0))
                    return BatchResultArrays(ids=z.astype(object), scores=z.astype(np.float32),
                                             valid=z.astype(bool), indices=z.astype(np.int32))
                return [[] for _ in range(n_real)]
            if ready is None:
                arrays = {k: v.cpu().numpy() for k, v in arrays.items()}
            else:  # this batch's copies only; own the memory: the pinned blocks are reused
                ready.synchronize()
                arrays = {k: v.numpy().copy() for k, v in arrays.items()}
            if return_arrays:
                return self._finish_arrays(n_real, arrays)
            idx = arrays.pop("idx")
            return self._batch_results(idx, with_payload, **arrays)[:n_real]

    # -- result assembly -----------------------------------------------------------

    def _ids_object_array(self) -> np.ndarray:
        if self._ids is None:
            self._ids = np.empty(len(self.index.manifest.ids), dtype=object)
            self._ids[:] = self.index.manifest.ids
        return self._ids

    def _finish_arrays(self, n_real: int, arrays) -> BatchResultArrays:
        idx = arrays["idx"][:n_real]
        primary = arrays.get("score_final")
        scores = (arrays["score"] if primary is None else primary)[:n_real]
        valid = (idx >= 0) & (idx < self.index.num_docs) & (scores > NEG_INF / 2)
        ids = self._ids_object_array()[np.where(valid, idx, 0)]
        ids[~valid] = None
        return BatchResultArrays(ids=ids, scores=scores, valid=valid,
                                 indices=np.where(valid, idx, -1))

    def _results(self, idx_l: List[int], with_payload: bool,
                 **cols: List[float]) -> List[Dict[str, Any]]:
        manifest = self.index.manifest
        first = next(iter(cols.values()))
        neg = NEG_INF / 2
        out: List[Dict[str, Any]] = []
        for rank, i in enumerate(idx_l):
            if i < 0 or first[rank] <= neg:
                continue
            rec: Dict[str, Any] = {"id": manifest.ids[i], "rank": rank}
            for col, arr in cols.items():
                rec[col] = arr[rank]
            rec.setdefault("score_final", rec.get("score", rec.get("score_stage2")))
            if with_payload:
                rec["payload"] = manifest.payload(i)
            out.append(rec)
        return out

    def _batch_results(self, idx: np.ndarray, with_payload: bool, **score_cols):
        idx_l = idx.tolist()  # one .tolist() per column, not per hit
        cols = {k: v.tolist() for k, v in score_cols.items()}
        return [self._results(idx_l[b], with_payload, **{k: v[b] for k, v in cols.items()})
                for b in range(len(idx_l))]
