"""Pooling of ColSmol page embeddings, as linear maps of the token rows.

Port of the ColSmol functions of ``visual_rag_tpu/ops/pooling.py``:
:func:`tile_level_mean_pooling` (``:268``), :func:`colsmol_experimental_pooling`
(``:326``) and :func:`global_mean_pooling` (``:425``), with their numpy
weight builders copied as they are. Each pooling is one static weight matrix
``W`` applied as ``W @ rows`` on the host, in numpy, as the JAX package's
ingest pools a page (bit for bit its host path). The ColPali and ColQwen
poolings come with their models, the 2-D tile pooling with the ingest slice.

Dtype contract (reference ``pooling.py:19-32``): compute in f32; the output
is ``output_dtype`` if given, else f16 inputs stay f16 and everything else
becomes f32.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

__all__ = [
    "tile_level_mean_pooling",
    "colsmol_experimental_pooling",
    "global_mean_pooling",
    "infer_output_dtype",
]


def infer_output_dtype(x, output_dtype=None) -> np.dtype:
    """fp16 -> fp16; anything else (incl. bf16) -> fp32, unless overridden."""
    if output_dtype is not None:
        return np.dtype(output_dtype)
    dt = str(getattr(x, "dtype", np.float32))
    if "float16" in dt and "bfloat16" not in dt:
        return np.dtype(np.float16)
    return np.dtype(np.float32)


def _as_f32(x) -> np.ndarray:
    return np.asarray(x, dtype=np.float32)


def _wmatmul(w_np: np.ndarray, emb: np.ndarray, out_dtype: np.dtype) -> np.ndarray:
    """weights @ emb (the weights are cached host arrays)."""
    return np.matmul(np.asarray(w_np, np.float32), emb).astype(out_dtype)


@lru_cache(maxsize=4096)
def _tile_mean_weights(num_tokens: int, num_tiles: int, patches_per_tile: int):
    """W[t, i] = 1/|tile t| for tokens i in tile t; partial last tile tolerated.

    If the token count is not num_tiles * patches_per_tile, the tile count is
    recomputed as ceil(num_tokens / patches_per_tile); trailing empty tiles
    are dropped.
    """
    if num_tokens != num_tiles * patches_per_tile:
        num_tiles = -(-num_tokens // patches_per_tile)  # ceil
    out_rows = 0
    starts = []
    for t in range(num_tiles):
        start = t * patches_per_tile
        if start >= num_tokens:
            break
        starts.append(start)
        out_rows += 1
    w = np.zeros((out_rows, num_tokens), dtype=np.float32)
    for t, start in enumerate(starts):
        end = min(start + patches_per_tile, num_tokens)
        w[t, start:end] = 1.0 / (end - start)
    return w


@lru_cache(maxsize=4096)
def _colsmol_experimental_weights(num_tokens: int, num_tiles: int, patches_per_tile: int):
    """Prefix tiles -> tile means; last tile -> raw patch passthrough, with
    the tile-count fixup when the last tile would start past the tokens."""
    last_tile_start = (num_tiles - 1) * patches_per_tile
    if last_tile_start >= num_tokens:
        num_tiles = -(-num_tokens // patches_per_tile)
        if num_tiles <= 0:
            raise ValueError("Not enough tokens for colsmol experimental pooling")
        last_tile_start = (num_tiles - 1) * patches_per_tile
    n_prefix = last_tile_start // patches_per_tile
    last_len = min(last_tile_start + patches_per_tile, num_tokens) - last_tile_start
    w = np.zeros((n_prefix + last_len, num_tokens), dtype=np.float32)
    for t in range(n_prefix):
        s = t * patches_per_tile
        w[t, s : s + patches_per_tile] = 1.0 / patches_per_tile
    for j in range(last_len):
        w[n_prefix + j, last_tile_start + j] = 1.0
    return w


def tile_level_mean_pooling(embedding, num_tiles: int, patches_per_tile: int = 64,
                            output_dtype=None):
    """[num_tokens, dim] -> [num_tiles, dim] per-tile means (partial last tile OK)."""
    out_dtype = infer_output_dtype(embedding, output_dtype)
    emb = _as_f32(embedding)
    w = _tile_mean_weights(int(emb.shape[0]), int(num_tiles), int(patches_per_tile))
    return _wmatmul(w, emb, out_dtype)


def colsmol_experimental_pooling(embedding, num_tiles: int, patches_per_tile: int = 64,
                                 output_dtype=None):
    """Tile means for all-but-last tile ++ raw last-tile patches."""
    out_dtype = infer_output_dtype(embedding, output_dtype)
    if int(num_tiles) <= 0:
        raise ValueError("num_tiles must be > 0")
    if int(patches_per_tile) <= 0:
        raise ValueError("patches_per_tile must be > 0")
    emb = _as_f32(embedding)
    w = _colsmol_experimental_weights(int(emb.shape[0]), int(num_tiles), int(patches_per_tile))
    return _wmatmul(w, emb, out_dtype)


def global_mean_pooling(embedding, output_dtype=None):
    """[num_tokens, dim] -> [dim] global mean."""
    out_dtype = infer_output_dtype(embedding, output_dtype)
    return _as_f32(embedding).mean(axis=0).astype(out_dtype)
