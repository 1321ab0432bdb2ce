"""Device-resident vector stores: padded, ragged and single-vector layouts.

Port of ``visual_rag_tpu/index/store.py:111-380`` for float storage
(float32, bfloat16, float16); int8, ``int8_refined`` and the ``res4``
sidecar come later (ROADMAP A6). Each store holds its tensors on one device.

The byte layout is the JAX package's, exactly: the ragged store's doc
blocks start on 32-row boundaries, and ``flat`` ends with a tail pad of
``ceil32(max_len)`` rows. The port's kernels read only the rows ``< len`` of
each doc, so they need neither; the layout is kept so that a store carried
across from the JAX package (``index/convert.py``) is the same bytes.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from visual_rag_tpu_torch.index.manifest import Manifest


def _storage_name(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


@dataclasses.dataclass
class PaddedMultiVectors:
    """Dense padded multivector store: values [D, P, dim], mask [D, P] bool."""

    values: torch.Tensor
    mask: torch.Tensor
    kind: str = "multi"

    @property
    def num_docs(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[2])

    @property
    def storage_dtype(self) -> str:
        return _storage_name(self.values)


@dataclasses.dataclass
class RaggedMultiVectors:
    """Ragged token store: flat [N + pad, dim] plus per-doc offsets/lengths.

    ``offsets`` and ``lengths`` are int32 [D], as in the JAX store; callers
    that index with them convert to int64 themselves.
    """

    flat: torch.Tensor
    offsets: torch.Tensor
    lengths: torch.Tensor
    max_len: int
    kind: str = "multi_ragged"

    @property
    def num_docs(self) -> int:
        return int(self.offsets.shape[0])

    @property
    def dim(self) -> int:
        return int(self.flat.shape[1])

    @property
    def storage_dtype(self) -> str:
        return _storage_name(self.flat)


@dataclasses.dataclass
class SingleVectors:
    """Dense single-vector store: values [D, dim]."""

    values: torch.Tensor
    kind: str = "single"

    @property
    def num_docs(self) -> int:
        return int(self.values.shape[0])

    @property
    def dim(self) -> int:
        return int(self.values.shape[1])

    @property
    def storage_dtype(self) -> str:
        return _storage_name(self.values)


@dataclasses.dataclass
class SealedIndex:
    """An immutable device-resident collection snapshot ready for queries."""

    stores: Dict[str, object]
    manifest: Manifest
    storage_dtype: str = "bfloat16"

    @property
    def num_docs(self) -> int:
        for s in self.stores.values():
            return s.num_docs
        return 0

    @property
    def vector_names(self):
        return sorted(self.stores.keys())

    @property
    def device(self) -> torch.device:
        st = next(iter(self.stores.values()))
        return (st.flat if isinstance(st, RaggedMultiVectors) else st.values).device

    def to(self, device) -> "SealedIndex":
        """A copy of the index with every tensor on ``device``."""
        stores = {
            name: dataclasses.replace(s, **{
                f.name: getattr(s, f.name).to(device) for f in dataclasses.fields(s)
                if isinstance(getattr(s, f.name), torch.Tensor)})
            for name, s in self.stores.items()}
        return SealedIndex(stores=stores, manifest=self.manifest,
                           storage_dtype=self.storage_dtype)

    def store(self, name: str):
        if name not in self.stores:
            raise KeyError(
                f"Named vector {name!r} not in collection (have: {self.vector_names})")
        return self.stores[name]
