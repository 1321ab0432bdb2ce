"""Pooling of page embeddings, as linear maps of the token rows.

Port of ``visual_rag_tpu/ops/pooling.py`` for ColSmol, ColPali and ColQwen2.5:
:func:`tile_level_mean_pooling` (``:268``), :func:`colsmol_experimental_pooling`
(``:326``), :func:`global_mean_pooling` (``:425``),
:func:`colpali_row_mean_pooling` (``:284``),
:func:`adaptive_row_mean_pooling_from_grid` (``:296``),
:func:`colpali_experimental_pooling_from_rows` (``:347``),
:func:`weighted_row_smoothing_same_length` (``:371``) and
:func:`sequence_chunk_mean_pooling` (``:431``), with their numpy weight
builders copied as they are. Each pooling is one static weight matrix ``W``
applied as ``W @ rows`` on the host, in numpy, as the JAX package's ingest
pools a page (bit for bit its host path). The 2-D tile pooling comes with
the ingest slice.

Dtype contract (reference ``pooling.py:19-32``): compute in f32; the output
is ``output_dtype`` if given, else f16 inputs stay f16 and everything else
becomes f32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

__all__ = [
    "tile_level_mean_pooling",
    "colpali_row_mean_pooling",
    "adaptive_row_mean_pooling_from_grid",
    "colsmol_experimental_pooling",
    "colpali_experimental_pooling_from_rows",
    "weighted_row_smoothing_same_length",
    "global_mean_pooling",
    "sequence_chunk_mean_pooling",
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
def _adaptive_bin_weights(h: int, target_rows: int):
    """Evenly spaced bins over [0, h) with floor/ceil edges and clipping
    (start = max(0, min(start, h - 1)), end = max(start + 1, min(end, h)))."""
    edges = np.linspace(0, h, target_rows + 1)
    w = np.zeros((target_rows, h), dtype=np.float32)
    for i in range(target_rows):
        start = int(np.floor(edges[i]))
        end = int(np.ceil(edges[i + 1]))
        start = max(0, min(start, h - 1))
        end = max(start + 1, min(end, h))
        w[i, start:end] = 1.0 / (end - start)
    return w


@lru_cache(maxsize=4096)
def _legacy_conv_weights(n: int, window_size: int):
    """Clipped-window "conv" producing n + 2r rows: center = i - r, window =
    rows[max(0, center - r) : min(n - 1, center + r) + 1]. Special cases:
    window_size 1 or n 1 -> identity; window_size 3 and n 2 -> [row0,
    mean(row0, row1), row1]."""
    if window_size == 1 or n == 1:
        return np.eye(n, dtype=np.float32)
    if window_size == 3 and n == 2:
        return np.array([[1.0, 0.0], [0.5, 0.5], [0.0, 1.0]], dtype=np.float32)
    r = window_size // 2
    out_n = n + 2 * r
    w = np.zeros((out_n, n), dtype=np.float32)
    for i in range(out_n):
        center = i - r
        lo = max(0, center - r)
        hi = min(n - 1, center + r)
        w[i, lo : hi + 1] = 1.0 / (hi + 1 - lo)
    return w


@lru_cache(maxsize=4096)
def _smoothing_weights(n: int, window_size: int, kernel: str, sigma: Optional[float]):
    """Same-length weighted smoothing W (n x n), edge-renormalized: kernel
    weights over a window of k positions centered at (k - 1) / 2 (even k
    too), normalized, then renormalized per row over the in-range
    positions; a row with no in-range weight falls back to identity."""
    k = window_size
    if k == 1 or n == 1:
        return np.eye(n, dtype=np.float32)
    center = (k - 1) / 2.0
    dist = np.abs(np.arange(k, dtype=np.float32) - center)
    if kernel == "uniform":
        base = np.ones((k,), dtype=np.float32)
    elif kernel == "triangular":
        base = np.clip((center + 1.0) - dist, 0.0, None).astype(np.float32)
    elif kernel == "gaussian":
        if sigma is None:
            sigma_eff = max(0.5, float(center) / 2.0)
        else:
            sigma_eff = float(sigma)
            if sigma_eff <= 0:
                raise ValueError("sigma must be > 0")
        base = np.exp(-0.5 * (dist / sigma_eff) ** 2).astype(np.float32)
    else:
        raise ValueError(f"Unknown kernel={kernel}. Choose uniform|triangular|gaussian.")
    s = float(base.sum())
    if s <= 0:
        return np.eye(n, dtype=np.float32)
    base = base / s
    left = k // 2
    w = np.zeros((n, n), dtype=np.float32)
    for i in range(n):
        start = i - left
        js = np.arange(start, start + k)
        valid = (js >= 0) & (js < n)
        total = float(base[valid].sum())
        if total > 0:
            w[i, js[valid]] = base[valid] / total
        else:
            w[i, i] = 1.0
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


def colpali_row_mean_pooling(embedding, grid_size: int = 32, output_dtype=None):
    """[g*g, dim] -> [g, dim] row means over a square grid."""
    out_dtype = infer_output_dtype(embedding, output_dtype)
    emb = _as_f32(embedding)
    g = int(grid_size)
    if int(emb.shape[0]) != g * g:
        raise ValueError(
            f"Expected {g * g} visual tokens for grid_size={g}, got {int(emb.shape[0])}")
    return emb.reshape(g, g, emb.shape[1]).mean(axis=1).astype(out_dtype)


def adaptive_row_mean_pooling_from_grid(embedding, *, grid_h: int, grid_w: int,
                                        target_rows: int = 32, output_dtype=None):
    """H x W grid -> row means -> adaptive bin means to ``target_rows`` (H 1
    repeats the row; H == target passes the rows through)."""
    out_dtype = infer_output_dtype(embedding, output_dtype)
    emb = _as_f32(embedding)
    h, w_, dim = int(grid_h), int(grid_w), int(emb.shape[1])
    if int(emb.shape[0]) != h * w_:
        raise ValueError(
            f"Expected {h * w_} visual tokens for grid {grid_h}x{grid_w}, got {int(emb.shape[0])}")
    target_rows = int(target_rows)
    if target_rows <= 0:
        raise ValueError("target_rows must be > 0")
    rows = emb.reshape(h, w_, dim).mean(axis=1)
    if h == target_rows:
        return rows.astype(out_dtype)
    if h == 1:
        return np.repeat(rows, target_rows, axis=0).astype(out_dtype)
    return _wmatmul(_adaptive_bin_weights(h, target_rows), rows, out_dtype)


def colpali_experimental_pooling_from_rows(row_vectors, *, window_size: int = 3,
                                           output_dtype=None):
    """Legacy clipped-window conv pooling: N rows -> N + 2 * (window // 2) rows."""
    out_dtype = infer_output_dtype(row_vectors, output_dtype)
    rows = _as_f32(row_vectors)
    n = int(rows.shape[0])
    if n < 1:
        raise ValueError("row_vectors must be non-empty")
    window_size = int(window_size)
    if window_size < 1:
        raise ValueError("window_size must be >= 1")
    if window_size % 2 == 0:
        raise ValueError("window_size must be odd")
    return _wmatmul(_legacy_conv_weights(n, window_size), rows, out_dtype)


def weighted_row_smoothing_same_length(row_vectors, *, window_size: int = 3,
                                       kernel: str = "gaussian", sigma: Optional[float] = None,
                                       output_dtype=None):
    """Weighted 1-D smoothing that keeps the row count (N -> N), even k too."""
    out_dtype = infer_output_dtype(row_vectors, output_dtype)
    rows = _as_f32(row_vectors)
    n = int(rows.shape[0])
    if n < 1:
        raise ValueError("row_vectors must be non-empty")
    k = int(window_size)
    if k < 1:
        raise ValueError("window_size must be >= 1")
    kernel = str(kernel).lower().strip()
    if kernel not in ("uniform", "triangular", "gaussian"):
        raise ValueError(f"Unknown kernel={kernel}. Choose uniform|triangular|gaussian.")
    return _wmatmul(_smoothing_weights(n, k, kernel, sigma), rows, out_dtype)


def sequence_chunk_mean_pooling(embedding, target_rows: int = 32, output_dtype=None):
    """Last-resort pooling: the token sequence cut into ``target_rows``
    linspace bins (the adaptive row pooling's bin rule)."""
    out_dtype = infer_output_dtype(embedding, output_dtype)
    emb = _as_f32(embedding)
    w = _adaptive_bin_weights(int(emb.shape[0]), int(target_rows))
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
