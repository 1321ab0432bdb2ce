"""Synthetic corpus generated on the device: a SealedIndex without host transfer.

Port of ``visual_rag_tpu/index/synth.py:41-171`` (``synthetic_index``) for
every storage dtype. Doc lengths, offsets and the tail pad come from the
same ``np.random.default_rng(seed)`` stream as the JAX version (``:62-70``),
so the layout matches it exactly; the vector values come from a
``torch.Generator`` on the target device and differ from ``jax.random``'s.

int8 stores use one global scale, 1/127 (rows are unit-normalised, so
``|x| <= 1``), as the JAX version does; ``int8_refined`` adds the per-row
int4 residual of each row as its ``fill_chunk`` does (``:88-107``): f32
rows, ``c8 = round(127 x)``, ``r = x - c8 / 127``, ``rs = max|r| / 7``.
"""

from __future__ import annotations

import numpy as np
import torch

from visual_rag_tpu_torch.device import resolve_device, storage_dtype as _torch_dtype
from visual_rag_tpu_torch.index.manifest import Manifest
from visual_rag_tpu_torch.index.store import (
    PaddedMultiVectors,
    RaggedMultiVectors,
    SealedIndex,
    SingleVectors,
)

ALIGN = 32  # doc block alignment of the ragged store (index/store.py)


def _fill_normalized(buf: torch.Tensor, gen: torch.Generator, chunk_rows: int,
                     res4=None, res_scales=None):
    """Fill ``buf`` [rows, dim] in place with row-normalised gaussians: the
    values, or for an int8 ``buf`` their codes at scale 1/127 (and, given
    ``res4``/``res_scales``, each row's int4 residual).

    Generated in chunks: the f32 intermediates exist only at chunk size, so
    a 100k-doc bf16 store (~5 GB) never needs an f32 copy of itself.
    """
    rows, dim = buf.shape
    for s in range(0, rows, chunk_rows):
        n = min(chunk_rows, rows - s)
        x = torch.randn((n, dim), generator=gen, device=buf.device,
                        dtype=torch.float32)
        x *= torch.rsqrt((x * x).sum(dim=-1, keepdim=True) + 1e-12)
        if buf.dtype != torch.int8:
            buf[s:s + n] = x.to(buf.dtype)
            continue
        c8 = torch.round(x * 127.0).clamp(-127, 127)
        buf[s:s + n] = c8.to(torch.int8)
        if res4 is not None:
            r = x - c8 * (1.0 / 127.0)
            rs = (r.abs().amax(dim=1) / 7.0).clamp(min=1e-12)
            c4 = torch.round(r / rs[:, None]).clamp(-7, 7).to(torch.int16) + 8
            res4[s:s + n] = (c4[:, 0::2] | (c4[:, 1::2] << 4)).to(torch.uint8)
            res_scales[s:s + n] = rs


def synthetic_index(
    num_docs: int,
    dim: int = 128,
    min_tokens: int = 128,
    max_tokens: int = 256,
    pooled_rows: int = 12,
    storage_dtype: str = "bfloat16",
    seed: int = 0,
    device="cuda",
    chunk_rows: int = 1 << 20,
) -> SealedIndex:
    """SealedIndex of ``num_docs`` synthetic pages generated on ``device``.

    Stores, as in the JAX version: ``initial`` (ragged, ``min_tokens`` to
    ``max_tokens`` rows per doc), ``mean_pooling`` and
    ``experimental_pooling`` (padded, ``pooled_rows`` rows each), and
    ``global_pooling`` (single vectors, float32, for every storage dtype).
    """
    sdt = _torch_dtype(storage_dtype)
    refined = storage_dtype == "int8_refined"
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    lengths = rng.integers(min_tokens, max_tokens + 1, num_docs).astype(np.int32)
    aligned = ((lengths + ALIGN - 1) // ALIGN) * ALIGN
    offsets = np.zeros(num_docs, np.int64)
    np.cumsum(aligned[:-1], out=offsets[1:])
    max_len = int(lengths.max())
    total = int(aligned.sum()) + ((max_len + 31) // 32) * 32

    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    flat = torch.empty((total, dim), dtype=sdt, device=dev)
    res4 = res_scales = None
    if refined:
        res4 = torch.empty((total, dim // 2), dtype=torch.uint8, device=dev)
        res_scales = torch.empty((total,), dtype=torch.float32, device=dev)
    _fill_normalized(flat, gen, chunk_rows, res4, res_scales)

    def scale(shape):  # the global int8 scale, None for float stores
        if sdt != torch.int8:
            return None
        return torch.full(shape, 1.0 / 127.0, dtype=torch.float32, device=dev)

    def padded():
        vals = torch.empty((num_docs, pooled_rows, dim), dtype=sdt, device=dev)
        _fill_normalized(vals.view(num_docs * pooled_rows, dim), gen, chunk_rows)
        return PaddedMultiVectors(
            values=vals,
            mask=torch.ones((num_docs, pooled_rows), dtype=torch.bool, device=dev),
            scales=scale((num_docs, pooled_rows)))

    glob = torch.empty((num_docs, dim), dtype=torch.float32, device=dev)
    stores = {
        "initial": RaggedMultiVectors(
            flat=flat,
            offsets=torch.from_numpy(offsets.astype(np.int32)).to(dev),
            lengths=torch.from_numpy(lengths).to(dev),
            max_len=max_len, scales=scale((num_docs,)), res4=res4,
            res_scales=res_scales),
        "mean_pooling": padded(),
        "experimental_pooling": padded(),
    }
    _fill_normalized(glob, gen, chunk_rows)
    stores["global_pooling"] = SingleVectors(values=glob)
    manifest = Manifest([f"d{i}" for i in range(num_docs)],
                        [{} for _ in range(num_docs)])
    return SealedIndex(stores=stores, manifest=manifest,
                       storage_dtype=storage_dtype)
