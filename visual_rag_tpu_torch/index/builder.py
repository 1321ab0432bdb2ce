"""Index builder: host-side accumulation -> a sealed collection on a device.

Port of ``visual_rag_tpu/index/builder.py:38-182``: :class:`VectorSpec`,
:class:`CollectionSchema` (``standard``, ``to_json``, ``from_json``) and
:class:`IndexBuilder` (``add``, ``upload_batch``, ``check_exists``,
``seal``). ``seal`` lays the vectors out with the store builders of
``index/store.py`` as the JAX seal does; an ``int8`` or ``int8_refined``
schema seals float32 stores and quantizes them with
``index/quantize.py::quantize_index``, which gives the JAX seal's bytes.
``save``/``load`` come with the persistence slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from visual_rag_tpu_torch.device import resolve_device, storage_dtype as _check_storage
from visual_rag_tpu_torch.index.manifest import Manifest
from visual_rag_tpu_torch.index.quantize import INT8_DTYPES, quantize_index
from visual_rag_tpu_torch.index.store import (
    DEFAULT_DIM,
    PaddedMultiVectors,
    RaggedMultiVectors,
    SealedIndex,
    SingleVectors,
)

VALID_LAYOUTS = ("ragged", "padded", "single")


@dataclasses.dataclass
class VectorSpec:
    """One named vector in the collection schema."""

    name: str
    layout: str  # ragged | padded | single
    dim: int = DEFAULT_DIM
    max_rows: Optional[int] = None  # padded layout row cap (None = max observed)

    def __post_init__(self):
        if self.layout not in VALID_LAYOUTS:
            raise ValueError(f"layout must be one of {VALID_LAYOUTS}, got {self.layout!r}")


@dataclasses.dataclass
class CollectionSchema:
    """Named-vector schema."""

    vectors: Dict[str, VectorSpec]
    storage_dtype: str = "bfloat16"

    @classmethod
    def standard(
        cls,
        experimental_names: Sequence[str] = ("experimental_pooling",),
        storage_dtype: str = "bfloat16",
        dim: int = DEFAULT_DIM,
    ) -> "CollectionSchema":
        """The default schema: initial + mean + global + experimental(s)."""
        vectors = {
            "initial": VectorSpec("initial", "ragged", dim),
            "mean_pooling": VectorSpec("mean_pooling", "padded", dim),
            "global_pooling": VectorSpec("global_pooling", "single", dim),
        }
        for name in experimental_names:
            vectors[name] = VectorSpec(name, "padded", dim)
        return cls(vectors=vectors, storage_dtype=storage_dtype)

    def to_json(self) -> Dict[str, Any]:
        return {
            "storage_dtype": self.storage_dtype,
            "vectors": {
                n: {"layout": v.layout, "dim": v.dim, "max_rows": v.max_rows}
                for n, v in self.vectors.items()
            },
        }

    @classmethod
    def from_json(cls, obj: Dict[str, Any]) -> "CollectionSchema":
        return cls(
            vectors={
                n: VectorSpec(n, v["layout"], v.get("dim", DEFAULT_DIM), v.get("max_rows"))
                for n, v in obj["vectors"].items()
            },
            storage_dtype=obj.get("storage_dtype", "bfloat16"),
        )


class IndexBuilder:
    """Accumulates points host-side; ``seal(device)`` produces the index."""

    def __init__(self, schema: CollectionSchema):
        _check_storage(schema.storage_dtype)
        self.schema = schema
        self.manifest = Manifest()
        self._vectors: Dict[str, List[np.ndarray]] = {n: [] for n in schema.vectors}

    def __len__(self) -> int:
        return len(self.manifest)

    def check_exists(self, point_id: str) -> bool:
        return point_id in self.manifest

    def add(
        self,
        point_id: str,
        vectors: Dict[str, np.ndarray],
        payload: Optional[Dict[str, Any]] = None,
        skip_existing: bool = True,
    ) -> bool:
        """Add one point. Returns False when skipped as already present."""
        if point_id in self.manifest:
            if skip_existing:
                return False
            raise ValueError(f"Point {point_id} already indexed")
        missing = set(self.schema.vectors) - set(vectors)
        if missing:
            raise ValueError(f"Point {point_id} missing named vectors: {sorted(missing)}")
        staged: Dict[str, np.ndarray] = {}
        for name, spec in self.schema.vectors.items():
            arr = np.asarray(vectors[name], dtype=np.float32)
            if spec.layout == "single":
                arr = arr.reshape(-1)
                if arr.shape[0] != spec.dim:
                    raise ValueError(f"{name}: expected dim {spec.dim}, got shape {arr.shape}")
            elif arr.ndim != 2 or arr.shape[1] != spec.dim:
                raise ValueError(f"{name}: expected [n, {spec.dim}] matrix, got shape {arr.shape}")
            staged[name] = arr
        self.manifest.add(point_id, payload)
        for name, arr in staged.items():
            self._vectors[name].append(arr)
        return True

    def upload_batch(self, points: Sequence[Dict[str, Any]], skip_existing: bool = True) -> int:
        """Batch add; each point dict has keys id/vectors/payload."""
        added = 0
        for p in points:
            if self.add(p["id"], p["vectors"], p.get("payload"), skip_existing=skip_existing):
                added += 1
        return added

    def seal(self, device="cuda") -> SealedIndex:
        """Lay out the accumulated vectors as stores on ``device``."""
        dev = resolve_device(device)
        dt = self.schema.storage_dtype
        # int8 stores are quantized from the float32 seal on the host
        build_dt, build_dev = ("float32", "cpu") if dt in INT8_DTYPES else (dt, dev)
        stores: Dict[str, object] = {}
        for name, spec in self.schema.vectors.items():
            mats = self._vectors[name]
            if spec.layout == "ragged":
                stores[name] = RaggedMultiVectors.build(mats, build_dt, dim=spec.dim,
                                                        device=build_dev)
            elif spec.layout == "padded":
                stores[name] = PaddedMultiVectors.build(mats, build_dt, max_rows=spec.max_rows,
                                                        dim=spec.dim, device=build_dev)
            else:
                stores[name] = SingleVectors.build(mats, build_dt, dim=spec.dim,
                                                   device=build_dev)
        index = SealedIndex(stores=stores, manifest=self.manifest, storage_dtype=build_dt)
        if dt in INT8_DTYPES:
            index = quantize_index(index, dt).to(dev)
        return index
