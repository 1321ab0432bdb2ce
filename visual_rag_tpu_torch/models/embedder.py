"""VisualEmbedder: the embedding facade on the port's ColVLM.

Counterpart of ``visual_rag_tpu/models/embedder.py`` for the ColSmol backend:

- ``embed_query`` / ``embed_queries`` with the optional length sort, the
  NaN/Inf guard that logs the query and recomputes it alone, and the
  special-token filter (``:144-201``);
- ``embed_images(return_token_info=True)`` with the f16 patch wire of
  ``:236-242`` (the model sees f16-rounded pixels on both sides) and the
  1-deep pipeline of ``:223-266``: batch i + 1 is dispatched, its inputs
  copied from pinned host memory without blocking, before batch i's output
  is read back;
- ``extract_visual_embedding`` and the ColSmol branches of
  ``mean_pool_visual_embedding``, ``experimental_pool_visual_embedding`` and
  ``global_pool_from_mean_pool`` (``:271-359``).

Other backends (ColPali, ColQwen2.5) and checkpoint loading raise
``NotImplementedError``. Weights are random from ``seed`` unless a
``state_dict`` (``params``) is given, e.g. one carried from the JAX model by
``models/convert.py::params_from_flax``. The model runs on ``device``
(``"cuda"`` by default; the CPU only when asked), where every attention goes
to the flash-attention kernel K10 (its plain version on the CPU).
"""

from __future__ import annotations

import json
import logging
import os
import time
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from visual_rag_tpu_torch.device import resolve_device
from visual_rag_tpu_torch.models.colvlm import ColVLMConfig
from visual_rag_tpu_torch.models.convert import build_model, init_params
from visual_rag_tpu_torch.models.processors import ImageProcessor
from visual_rag_tpu_torch.models.tokenizer import load_tokenizer
from visual_rag_tpu_torch.ops import pooling as pool_ops

logger = logging.getLogger(__name__)

# visual_rag_tpu/models/embedder.py:41-47
MODEL_BACKENDS = {
    "colsmol": "colsmol",
    "colqwen2.5": "colqwen2.5",
    "colqwen2_5": "colqwen2.5",
    "colqwen2": "colqwen2",
    "colpali": "colpali",
}


def detect_backend(model_name: str) -> str:
    name = (model_name or "").lower()
    for key, backend in MODEL_BACKENDS.items():
        if key in name:
            return backend
    return "colpali"


class VisualEmbedder:
    """Late-interaction embedder over the port's ColVLM (ColSmol)."""

    def __init__(
        self,
        model_name: str = "vidore/colSmol-500M",
        batch_size: int = 8,
        output_dtype=np.float32,
        config: Optional[ColVLMConfig] = None,
        params: Optional[Dict[str, torch.Tensor]] = None,  # the port's state_dict
        checkpoint: Optional[str] = None,
        seed: int = 0,
        sort_queries_by_length: Optional[bool] = None,
        nan_log_dir: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        device="cuda",
    ):
        self.model_name = model_name
        self.backend = detect_backend(model_name)
        if self.backend != "colsmol":
            raise NotImplementedError(
                f"the port embeds with ColSmol only; {model_name!r} needs the "
                f"{self.backend} backend (a later slice)")
        if checkpoint is not None:
            raise NotImplementedError("loading an HF checkpoint into the port is not ported yet")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.output_dtype = np.dtype(output_dtype)
        self.cfg = config or ColVLMConfig.colsmol_500m()
        self._params = params
        self._seed = seed
        self._model = None
        ratio = max(self.cfg.spatial_merge ** 2, self.cfg.vision.pixel_shuffle ** 2, 1)
        tokenizer_path = tokenizer_path or os.environ.get("VISUALRAG_TOKENIZER")
        tokenizer = load_tokenizer(tokenizer_path, vocab=self.cfg.text.vocab)
        image_token_id = tokenizer.token_to_id("<image>") or self.cfg.image_token_id
        self.tokenizer = tokenizer
        self.processor = ImageProcessor(
            backend=self.backend,
            image_token_id=image_token_id,
            patch_pixels=self.cfg.vision.patch_pixels,
            vocab=self.cfg.text.vocab,
            max_visual_tokens=self.cfg.vision.max_patches // ratio,
            pixel_shuffle=self.cfg.vision.pixel_shuffle,
            tokenizer=tokenizer,
        )
        if sort_queries_by_length is None:
            sort_queries_by_length = os.environ.get(
                "VISUALRAG_SORT_QUERIES_BY_LENGTH", "0") in ("1", "true")
        self.sort_queries_by_length = bool(sort_queries_by_length)
        self.nan_log_dir = nan_log_dir or os.environ.get(
            "VISUALRAG_NAN_LOG_DIR", "results/nan_samples")

    # -- parameters (made on first use, as the JAX embedder's) ---------------

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        if self._params is None:
            logger.info("Initializing %s (%s) parameters", self.model_name, self.backend)
            self._params = init_params(self.cfg, self._seed, self.device)
        return self._params

    @property
    def model(self):
        if self._model is None:
            self._model = build_model(self.cfg, self.params, self.device)
        return self._model

    def _to_device(self, arrays):
        """Host arrays -> device tensors: pinned and copied without blocking
        on a CUDA device, so the copy overlaps the previous batch's work."""
        out = []
        for a in arrays:
            t = torch.from_numpy(np.ascontiguousarray(a))
            if self.device.type == "cuda":
                t = t.pin_memory()
            out.append(t.to(self.device, non_blocking=True))
        return out

    # -- queries -------------------------------------------------------------

    def embed_query(self, query: str,
                    include_special_tokens: Optional[bool] = None) -> np.ndarray:
        return self.embed_queries([query], include_special_tokens=include_special_tokens)[0]

    def embed_queries(
        self,
        queries: Sequence[str],
        batch_size: Optional[int] = None,
        include_special_tokens: Optional[bool] = None,
    ) -> List[np.ndarray]:
        """Batched query embedding with NaN guard + solo-recompute fallback."""
        if include_special_tokens is None:
            include_special_tokens = os.environ.get(
                "VISUALRAG_INCLUDE_SPECIAL_TOKENS", "0") in ("1", "true")
        batch_size = batch_size or self.batch_size
        order = list(range(len(queries)))
        if self.sort_queries_by_length:
            order.sort(key=lambda i: len(queries[i].split()))
        results: List[Optional[np.ndarray]] = [None] * len(queries)
        for s in range(0, len(order), batch_size):
            chunk = order[s : s + batch_size]
            embs = self._embed_query_batch([queries[i] for i in chunk], include_special_tokens)
            for i, e in zip(chunk, embs):
                if not np.isfinite(e).all():
                    self._log_nan_sample(queries[i])
                    e = self._embed_query_batch([queries[i]], include_special_tokens)[0]
                    if not np.isfinite(e).all():
                        e = np.nan_to_num(e)
                results[i] = e
        return results  # type: ignore[return-value]

    def _embed_query_batch(self, texts, include_special_tokens):
        ids, mask = self.processor.process_queries(texts)
        ids_d, mask_d = self._to_device((ids, mask))
        with torch.inference_mode():
            emb = self.model.embed_queries(ids_d, mask_d).float().cpu().numpy()
        out = []
        for i in range(len(texts)):
            keep = mask[i]
            if not include_special_tokens:
                keep = keep & ~self.tokenizer.special_mask(ids[i])
            out.append(emb[i][keep].astype(self.output_dtype))
        return out

    def _log_nan_sample(self, query: str) -> None:
        try:
            path = Path(self.nan_log_dir)
            path.mkdir(parents=True, exist_ok=True)
            with open(path / "nan_queries.jsonl", "a", encoding="utf-8") as f:
                f.write(json.dumps({
                    "ts": time.time(), "model": self.model_name, "query": query,
                }) + "\n")
        except OSError:  # logging must never break embedding
            pass
        logger.warning("NaN/Inf in query embedding; recomputing solo: %r", query[:80])

    # -- images --------------------------------------------------------------

    def embed_images(
        self,
        images: Sequence,
        batch_size: Optional[int] = None,
        return_token_info: bool = False,
        show_progress: bool = False,
    ) -> Union[List[np.ndarray], Tuple[List[np.ndarray], List[Dict[str, Any]]]]:
        batch_size = batch_size or self.batch_size
        embeddings: List[np.ndarray] = []
        infos: List[Dict[str, Any]] = []

        def drain(device_out, proc):
            emb = device_out.float().cpu().numpy()
            for i, info in enumerate(proc.token_infos):
                n_valid = int(proc.attn_mask[i].sum())
                embeddings.append(emb[i, :n_valid].astype(self.output_dtype))
                infos.append(info)

        pending = None
        for s in range(0, len(images), batch_size):
            proc = self.processor.process_images(list(images[s : s + batch_size]))
            # f16 wire for the patches, as the JAX embedder ships them: pixels
            # rounded to f16 on the host, cast to the model dtype on the device
            host = [proc.input_ids, proc.attn_mask, proc.patches.astype(np.float16),
                    proc.patch_mask]
            if proc.window_ids is not None:
                host.append(proc.window_ids)
            dev = self._to_device(host)
            wids = dev[4] if proc.window_ids is not None else None
            with torch.inference_mode():
                out = self.model.embed_pages(dev[0], dev[1], dev[2], dev[3], wids)
            if pending is not None:
                drain(*pending)
            pending = (out, proc)
        if pending is not None:
            drain(*pending)
        if return_token_info:
            return embeddings, infos
        return embeddings

    def extract_visual_embedding(self, full_embedding, token_info) -> np.ndarray:
        """Gather the visual-token rows (``embedder.py:271-274``)."""
        idx = np.asarray(token_info["visual_token_indices"], dtype=np.int64)
        return np.asarray(full_embedding)[idx].astype(self.output_dtype)

    # -- pooling (the ColSmol branches of embedder.py:278-359) ----------------

    def mean_pool_visual_embedding(self, visual_embedding,
                                   token_info: Optional[Dict[str, Any]] = None, *,
                                   target_vectors: Optional[int] = 32) -> np.ndarray:
        """Per-tile means; ``target_vectors`` is the other backends' cap and
        is not read on ColSmol."""
        visual_np = np.asarray(visual_embedding, dtype=np.float32)
        info = token_info or {}
        n_rows, n_cols = info.get("n_rows"), info.get("n_cols")
        num_tiles = int(n_rows) * int(n_cols) + 1 if n_rows and n_cols else 13
        return np.asarray(pool_ops.tile_level_mean_pooling(
            visual_np, num_tiles=num_tiles, patches_per_tile=64,
            output_dtype=self.output_dtype))

    def global_pool_from_mean_pool(self, mean_pool: np.ndarray) -> np.ndarray:
        if mean_pool.size == 0:
            return np.zeros((self.cfg.embed_dim,), dtype=self.output_dtype)
        return np.asarray(mean_pool, dtype=np.float32).mean(axis=0).astype(self.output_dtype)

    def experimental_pool_visual_embedding(self, visual_embedding,
                                           token_info: Optional[Dict[str, Any]] = None, *,
                                           target_vectors: Optional[int] = 32,
                                           mean_pool: Optional[np.ndarray] = None,
                                           window_size: Optional[int] = None,
                                           kernel: Optional[str] = None) -> np.ndarray:
        """Tile means of all tiles but the last, then the last (global)
        tile's raw tokens. ``window_size`` and ``kernel`` belong to the other
        backends' smoothing and are not read on ColSmol."""
        visual_np = np.asarray(visual_embedding, dtype=np.float32)
        if mean_pool is not None and getattr(mean_pool, "shape", None) and mean_pool.shape[0] > 0:
            num_tiles = int(mean_pool.shape[0])
        else:
            info = token_info or {}
            num_tiles = info.get("num_tiles")
            if num_tiles is None:
                nv = info.get("num_visual_tokens") or int(visual_np.shape[0])
                num_tiles = -(-int(nv) // 64)
        return np.asarray(pool_ops.colsmol_experimental_pooling(
            visual_np, num_tiles=int(num_tiles), patches_per_tile=64,
            output_dtype=self.output_dtype))
