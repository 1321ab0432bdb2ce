"""Synthetic collections and queries, drawn from a seed.

Widened from the program's ``index/synth.py::synthetic_index`` (and the JAX
package's, ``visual_rag_tpu/index/synth.py:41-171``): row-normalised
gaussian token rows made on the card in chunks by a ``torch.Generator``,
laid out as the sealed stores' bytes (doc blocks on 32-row boundaries and
a tail pad of ``ceil32(max_len)`` rows). What it adds: doc lengths from a
fixed multiset that the seed only permutes (every seed gets the same
number of rows, so its work is the same) and pooled rows with holes
(``pooled_valid``). The store classes are the program's; the
numbers are the harness's own.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

import numpy as np
import torch

ALIGN = 32
CHUNK_ROWS = 1 << 20


def spread(lo: int, hi: int, n: int, rng: np.random.Generator) -> np.ndarray:
    """n integers covering [lo, hi] evenly (a fixed multiset), in an order
    the seed draws."""
    vals = lo + (np.arange(n, dtype=np.int64) * (hi - lo + 1)) // max(n, 1)
    return rng.permutation(vals)


def fill_unit_rows(buf: torch.Tensor, gen: torch.Generator) -> None:
    """Row-normalised gaussians into ``buf`` [rows, dim] (any float dtype),
    in chunks, so the f32 transient is a chunk's."""
    rows, dim = buf.shape
    for s in range(0, rows, CHUNK_ROWS):
        n = min(CHUNK_ROWS, rows - s)
        x = torch.randn((n, dim), generator=gen, device=buf.device, dtype=torch.float32)
        x *= torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
        buf[s:s + n] = x.to(buf.dtype)


@dataclasses.dataclass
class Corpus:
    """The harness's own tensors of a collection (the reference reads these,
    never the engine's copies) and the program's ``SealedIndex`` over them."""

    flat: torch.Tensor  # [rows, dim]
    offsets: torch.Tensor  # [D] int32
    lengths: torch.Tensor  # [D] int32
    pooled: torch.Tensor  # [D, P, dim] (mean_pooling)
    pooled_mask: torch.Tensor  # [D, P] bool
    index: object
    lengths_np: np.ndarray
    pooled_valid_np: np.ndarray

    @property
    def num_docs(self) -> int:
        return int(self.offsets.shape[0])


def build_corpus(p: Dict, seed: int, device) -> Corpus:
    """A collection by the mix's parameters ``p``:

    - ``docs``; ``dim``; ``storage_dtype`` (a float dtype);
    - tokens a doc: ``tokens`` [lo, hi];
    - ``pooled_rows`` P of ``mean_pooling`` and ``experimental_pooling``,
      valid rows ``pooled_valid`` [lo, hi] (the rest masked).
    """
    from visual_rag_tpu_torch.index.manifest import Manifest
    from visual_rag_tpu_torch.index.store import (
        PaddedMultiVectors,
        RaggedMultiVectors,
        SealedIndex,
        SingleVectors,
    )

    n, dim, pr = int(p["docs"]), int(p.get("dim", 128)), int(p["pooled_rows"])
    sdt = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}[p.get("storage_dtype", "bfloat16")]
    rng = np.random.default_rng(seed)
    lengths = spread(*p["tokens"], n, rng).astype(np.int32)
    valid = spread(*p["pooled_valid"], n, rng).astype(np.int32)
    if valid.max() > pr:
        raise ValueError(f"pooled_valid up to {valid.max()} exceeds pooled_rows {pr}")
    aligned = (lengths.astype(np.int64) + ALIGN - 1) // ALIGN * ALIGN
    offsets = np.zeros(n, np.int64)
    np.cumsum(aligned[:-1], out=offsets[1:])
    max_len = int(lengths.max())
    total = int(aligned.sum()) + (max_len + 31) // 32 * 32

    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    flat = torch.empty((total, dim), dtype=sdt, device=device)
    fill_unit_rows(flat, gen)
    valid_t = torch.from_numpy(valid).to(device)
    pmask = torch.arange(pr, device=device)[None, :] < valid_t[:, None]

    def padded():
        vals = torch.empty((n, pr, dim), dtype=sdt, device=device)
        fill_unit_rows(vals.view(n * pr, dim), gen)
        vals.masked_fill_(~pmask[..., None], 0)
        return vals

    mean_vals, exp_vals = padded(), padded()
    glob = torch.empty((n, dim), dtype=torch.float32, device=device)
    fill_unit_rows(glob, gen)
    offsets_t = torch.from_numpy(offsets.astype(np.int32)).to(device)
    lengths_t = torch.from_numpy(lengths).to(device)
    stores = {
        "initial": RaggedMultiVectors(flat=flat, offsets=offsets_t, lengths=lengths_t,
                                      max_len=max_len),
        "mean_pooling": PaddedMultiVectors(values=mean_vals, mask=pmask),
        "experimental_pooling": PaddedMultiVectors(values=exp_vals, mask=pmask.clone()),
        "global_pooling": SingleVectors(values=glob),
    }
    manifest = Manifest([f"d{i}" for i in range(n)], [{} for _ in range(n)])
    index = SealedIndex(stores=stores, manifest=manifest,
                        storage_dtype=p.get("storage_dtype", "bfloat16"))
    return Corpus(flat, offsets_t, lengths_t, mean_vals, pmask, index, lengths, valid)


def make_queries(p: Dict, n: int, seed: int) -> List[np.ndarray]:
    """n raw query embeddings [tokens, dim] f32 (unnormalised, as an
    embedder hands them over): token counts from the fixed multiset
    ``query_tokens`` [lo, hi], in the seed's order."""
    rng = np.random.default_rng([seed, 1])
    dim = int(p.get("dim", 128))
    lens = spread(*p["query_tokens"], n, rng)
    flat = rng.standard_normal((int(lens.sum()), dim), dtype=np.float32)
    ends = np.cumsum(lens)
    return [flat[e - k:e] for e, k in zip(ends.tolist(), lens.tolist())]


def doc_ids(ids: Sequence) -> np.ndarray:
    """Manifest ids ``d<i>`` (None where no hit) -> int64 doc indices (-1)."""
    return np.array([-1 if i is None else int(str(i)[1:]) for i in ids], np.int64)
