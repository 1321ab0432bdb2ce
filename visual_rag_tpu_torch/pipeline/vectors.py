"""From a page's token embeddings to the collection's named vectors.

The vector part of the JAX ingest pipeline (``visual_rag_tpu/pipeline/
pipeline.py``): :func:`experimental_vector_plan` (``:38-75``) copied as it
is, and :func:`page_vectors`, the vector and token-info half of
``ProcessingPipeline._process_single_page`` and ``_produce_experimental``
(``:281-354``) with the pipeline's defaults (strategy ``"pooling"``, window
3, kernel ``"auto"``, no 2-D variant), for the backends the port embeds
with: ``initial`` holds the visual tokens, then ``mean_pooling``,
``global_pooling``, one vector per producer of the plan (ColSmol:
``experimental_pooling``; ColPali: ``experimental_pooling_3``, the legacy
conv; ColQwen: ``experimental_pooling_gaussian`` and
``experimental_pooling_triangular``, window 3) and the
``experimental_pooling`` alias column, the canonical producer's. A caller seals them under
``CollectionSchema.standard(experimental_names=plan["names"])``. The other
strategies, PDF rendering, cropping, page-image upload, the upload queue and
the ``colsmol_2d`` vector come with the ingest/CLI slice.
"""

from __future__ import annotations

from typing import Any, Dict, Sequence, Tuple

import numpy as np

MAX_MEAN_POOL_VECTORS = 32  # ProcessingPipeline's default (pipeline.py:98); unread by ColSmol


def experimental_vector_plan(
    backend: str,
    pooling_windows: Sequence[int] = (3,),
    kernel: str = "auto",
    colsmol_2d: bool = False,
) -> Dict[str, Any]:
    """Centralized experimental-vector naming + production plan.

    Returns {"names": [...], "canonical": str, "producers": {name: spec}}:
    - ColQwen2.5 (and Kimi-VL, whose merged grid is ColQwen's): gaussian +
      triangular k=3 always; canonical = gaussian (alias 'experimental_pooling')
    - ColPali: one vector per window k (legacy conv); canonical = first k
    - ColSmol: tile-structured pooling; optional 2d 4-neighborhood variant
    """
    producers: Dict[str, Dict[str, Any]] = {}
    if backend in ("colqwen2.5", "colqwen2", "kimivl"):
        for tech in ("gaussian", "triangular"):
            producers[f"experimental_pooling_{tech}"] = {"kind": "smooth", "kernel": tech, "window": 3}
        canonical = "experimental_pooling_gaussian"
    elif backend == "colsmol":
        producers["experimental_pooling"] = {"kind": "colsmol"}
        if colsmol_2d:
            producers["experimental_pooling_2d"] = {"kind": "colsmol_2d"}
        canonical = "experimental_pooling"
    else:  # colpali
        windows = list(pooling_windows) or [3]
        for k in windows:
            name = f"experimental_pooling_{k}"
            if kernel in ("auto", "legacy", "legacy_conv", "conv"):
                producers[name] = {"kind": "legacy", "window": int(k)}
            else:
                producers[name] = {"kind": "smooth", "kernel": kernel, "window": int(k)}
        canonical = f"experimental_pooling_{windows[0]}"
    names = list(producers.keys())
    if "experimental_pooling" not in names:
        names.append("experimental_pooling")  # canonical alias column
    return {"names": names, "canonical": canonical, "producers": producers}


def page_vectors(embedder, emb: np.ndarray,
                 info: Dict[str, Any]) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """(named vectors, token-info payload fields) of one embedded page.

    ``emb`` and ``info`` are one page's output of
    ``embedder.embed_images(..., return_token_info=True)``. The payload
    fields are those ``_process_single_page`` derives from the token info
    (``pipeline.py:331-346``), with the pipeline's defaults; the caller adds
    its own (file name, page number, metadata).
    """
    plan = experimental_vector_plan(embedder.backend)
    visual = embedder.extract_visual_embedding(emb, info)
    mean_pool = np.asarray(embedder.mean_pool_visual_embedding(
        visual, info, target_vectors=MAX_MEAN_POOL_VECTORS))
    experimental = {}
    for name, spec in plan["producers"].items():  # pipeline.py:286-297
        if spec["kind"] not in ("colsmol", "legacy", "smooth"):
            raise NotImplementedError(f"the {spec['kind']} experimental vector is not ported")
        extra = {} if spec["kind"] == "colsmol" else dict(
            kernel=spec.get("kernel", "legacy"), window_size=spec["window"])
        experimental[name] = np.asarray(embedder.experimental_pool_visual_embedding(
            visual, info, mean_pool=mean_pool, **extra))
    experimental["experimental_pooling"] = experimental.get(
        "experimental_pooling", experimental[plan["canonical"]])
    global_pool = np.asarray(embedder.global_pool_from_mean_pool(mean_pool))
    payload = {
        "num_visual_tokens": int(info.get("num_visual_tokens") or visual.shape[0]),
        "n_rows": info.get("n_rows"),
        "n_cols": info.get("n_cols"),
        "num_tiles": info.get("num_tiles"),
        "grid_h_eff": info.get("grid_h_eff"),
        "grid_w_eff": info.get("grid_w_eff"),
        "visual_token_indices": list(info.get("visual_token_indices") or []),
        "pooling": {
            "strategy": "pooling",
            "mean_pool_rows": int(mean_pool.shape[0]),
            "experimental": sorted(plan["producers"].keys()),
            "canonical_experimental": plan["canonical"],
            "max_mean_pool_vectors": MAX_MEAN_POOL_VECTORS,
        },
    }
    vectors = {
        "initial": np.asarray(visual, dtype=np.float32),
        "mean_pooling": np.asarray(mean_pool, dtype=np.float32),
        "global_pooling": np.asarray(global_pool, dtype=np.float32),
        **{k: np.asarray(v, dtype=np.float32) for k, v in experimental.items()},
    }
    return vectors, payload
