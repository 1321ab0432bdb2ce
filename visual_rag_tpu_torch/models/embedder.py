"""VisualEmbedder: the embedding facade on the port's ColVLM.

Counterpart of ``visual_rag_tpu/models/embedder.py`` for every backend of
its ``_CONFIG_BY_BACKEND`` (``:49-54``): ColSmol-500M, ColPali-v1.3 and
ColQwen2.5-v0.2 (the ``colqwen2.5`` and ``colqwen2`` names both), and one
the JAX package lacks, ``kimivl`` (Kimi-VL-A3B-Instruct under ColQwen's
retrieval head: its merged grid pools as ColQwen2.5's does, and its pages
carry their patch grids to the model for MoonViT's positions):

- ``embed_query`` / ``embed_queries`` with the optional length sort, the
  NaN/Inf guard that logs the query and recomputes it alone, and the
  special-token filter (``:144-201``);
- ``embed_images(return_token_info=True)`` with the f16 patch wire of
  ``:236-242`` (the model sees f16-rounded pixels on both sides), the window
  ids and ColQwen's int32 patch positions shipped beside the patches
  (``:243-261``), and the 1-deep pipeline of ``:223-266``: batch i + 1 is
  dispatched, its inputs copied from pinned host memory without blocking,
  before batch i's output is read back;
- ``extract_visual_embedding``, ``mean_pool_visual_embedding``,
  ``experimental_pool_visual_embedding`` and ``global_pool_from_mean_pool``
  (``:271-359``), every branch (the ColQwen grid branch needs only numpy).

Checkpoint loading raises ``NotImplementedError``. Weights are random from
``seed``, drawn on
``device``, unless a ``state_dict`` (``params``) is given, e.g. one carried
from the JAX model by ``models/convert.py::params_from_flax`` or from an HF
state dict by ``params_from_hf``. The model runs on ``device`` (``"cuda"``
by default; the CPU only when asked), where every attention goes to the
flash-attention kernel K10 (its plain version on the CPU).
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
from visual_rag_tpu_torch.models.colvlm import ColVLMConfig, check_supported
from visual_rag_tpu_torch.models.convert import build_model, init_params
from visual_rag_tpu_torch.models.processors import ImageProcessor
from visual_rag_tpu_torch.models.tokenizer import load_tokenizer
from visual_rag_tpu_torch.ops import pooling as pool_ops
from visual_rag_tpu_torch.tracing import span

logger = logging.getLogger(__name__)

# visual_rag_tpu/models/embedder.py:41-47
MODEL_BACKENDS = {
    "colsmol": "colsmol",
    "colqwen2.5": "colqwen2.5",
    "colqwen2_5": "colqwen2.5",
    "colqwen2": "colqwen2",
    "colpali": "colpali",
    "kimi-vl": "kimivl",
    "kimivl": "kimivl",
}


# visual_rag_tpu/models/embedder.py:49-54
_CONFIG_BY_BACKEND = {
    "colsmol": ColVLMConfig.colsmol_500m,
    "colpali": ColVLMConfig.colpali_v13,
    "colqwen2.5": ColVLMConfig.colqwen25_v02,
    "colqwen2": ColVLMConfig.colqwen25_v02,
    "kimivl": ColVLMConfig.kimi_vl_a3b,
}
# the backends whose image tokens form one 2-D merged grid, pooled by its rows
GRID_BACKENDS = ("colqwen2.5", "kimivl")


def detect_backend(model_name: str) -> str:
    name = (model_name or "").lower()
    for key, backend in MODEL_BACKENDS.items():
        if key in name:
            return backend
    return "colpali"


class VisualEmbedder:
    """Late-interaction embedder over the port's ColVLM (ColSmol, ColPali,
    ColQwen2.5)."""

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
        if checkpoint is not None:
            raise NotImplementedError("loading an HF checkpoint into the port is not ported yet")
        self.device = resolve_device(device)
        self.batch_size = int(batch_size)
        self.output_dtype = np.dtype(output_dtype)
        self.cfg = config or _CONFIG_BY_BACKEND[self.backend]()
        check_supported(self.cfg)  # refuse now, not at the first batch
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
            pages = list(images[s : s + batch_size])
            proc = self.processor.process_images(pages)
            with span("embed.to_device", pages=len(pages)):
                # f16 wire for the patches, as the JAX embedder ships them: pixels
                # rounded to f16 on the host, cast to the model dtype on the device
                host = [proc.input_ids, proc.attn_mask, proc.patches.astype(np.float16),
                        proc.patch_mask]
                extra = [proc.window_ids, proc.patch_positions]  # either may be None
                dev = self._to_device(host + [a for a in extra if a is not None])
            it = iter(dev[4:])
            wids, ppos = (None if a is None else next(it) for a in extra)
            grids = ([(info["grid_h"], info["grid_w"]) for info in proc.token_infos]
                     if self.cfg.vision.moonvit_pos_grid else None)
            with torch.inference_mode():
                out = self.model.embed_pages(dev[0], dev[1], dev[2], dev[3], wids, ppos, grids)
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

    # -- pooling dispatch (embedder.py:278-359) ---------------------------------

    def mean_pool_visual_embedding(self, visual_embedding,
                                   token_info: Optional[Dict[str, Any]] = None, *,
                                   target_vectors: Optional[int] = 32) -> np.ndarray:
        """ColSmol: per-tile means. ColQwen2.5 and Kimi-VL: adaptive row means
        of the effective grid under the ``target_vectors`` cap. Otherwise (ColPali):
        row means of a square grid (adaptive bins where the grid is not the
        cap), else sequence chunks."""
        on_grid = self.backend in GRID_BACKENDS
        cap = None if target_vectors is None or int(target_vectors) <= 0 else int(target_vectors)
        if not on_grid and cap is None:
            cap = 32
        visual_np = np.asarray(visual_embedding, dtype=np.float32)
        num_tokens = int(visual_np.shape[0])
        info = token_info or {}

        if self.backend == "colsmol":
            n_rows, n_cols = info.get("n_rows"), info.get("n_cols")
            num_tiles = int(n_rows) * int(n_cols) + 1 if n_rows and n_cols else 13
            return np.asarray(pool_ops.tile_level_mean_pooling(
                visual_np, num_tiles=num_tiles, patches_per_tile=64,
                output_dtype=self.output_dtype))

        if on_grid:
            gh, gw = info.get("grid_h_eff"), info.get("grid_w_eff")
            if gh and gw and int(gh) * int(gw) == num_tokens:
                target_rows = int(gh) if cap is None else min(cap, int(gh))
                return np.asarray(pool_ops.adaptive_row_mean_pooling_from_grid(
                    visual_np, grid_h=int(gh), grid_w=int(gw), target_rows=target_rows,
                    output_dtype=self.output_dtype))

        grid = int(round(num_tokens ** 0.5))
        if grid * grid == num_tokens:
            target = grid if (on_grid and cap is None) else int(cap)
            if grid == target:
                return np.asarray(pool_ops.colpali_row_mean_pooling(
                    visual_np, grid_size=target, output_dtype=self.output_dtype))
            return np.asarray(pool_ops.adaptive_row_mean_pooling_from_grid(
                visual_np, grid_h=grid, grid_w=grid, target_rows=target,
                output_dtype=self.output_dtype))

        return np.asarray(pool_ops.sequence_chunk_mean_pooling(
            visual_np, target_rows=int(cap or 32), output_dtype=self.output_dtype))

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
        """ColSmol: tile means of all tiles but the last, then the last
        (global) tile's raw tokens. Otherwise the mean-pooled rows smoothed:
        the legacy clipped-window conv (ColPali's default, window 3; N rows
        -> N + 2) or a same-length gaussian, triangular or uniform kernel
        (ColQwen2.5's default: gaussian)."""
        on_grid = self.backend in GRID_BACKENDS
        visual_np = np.asarray(visual_embedding, dtype=np.float32)

        if self.backend == "colsmol":
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

        rows = mean_pool if mean_pool is not None else self.mean_pool_visual_embedding(
            visual_np, token_info, target_vectors=target_vectors)
        k = (kernel or ("gaussian" if on_grid else "legacy")).lower().strip()
        if k in ("legacy", "legacy_conv", "conv"):
            window = int(window_size) if window_size is not None else (5 if on_grid else 3)
            return np.asarray(pool_ops.colpali_experimental_pooling_from_rows(
                rows, window_size=window, output_dtype=self.output_dtype))
        window = int(window_size) if window_size is not None else 3
        return np.asarray(pool_ops.weighted_row_smoothing_same_length(
            rows, window_size=window,
            kernel=k if k in ("gaussian", "triangular") else "uniform",
            output_dtype=self.output_dtype))
