"""Plain reference of the two configurations' ColVLM: the processor, the
forward pass, the training loss and step, and the page vectors.

Plain PyTorch in f32 (TF32 off), one sequence at a time, with no kernel,
cache or batching; it imports nothing of the program. It follows the
published architectures as the configuration files state them, with the
departures they list:

- Qwen2.5-VL (``qwen2_5_vl``): 14-px patches (588 values, the two equal
  frames of the Conv3d folded), in 2 x 2 merge-block order; vision blocks
  of RMSNorm, biased attention (within 8 x 8-patch windows, all patches in
  the full layers) and a biased SiLU-gated MLP; the merger (RMSNorm, four
  patches folded into one row, a tanh-GELU MLP); the Qwen2.5 decoder
  (RMSNorm, q/k/v biases, grouped kv heads, causal, rotary over the text
  positions: training passes no patch positions, so M-RoPE's three axes
  are equal and it is the 1-D rotary).
- Idefics3 (``idefics3``): the image resized to its 512-px tile grid and a
  global tile, 16-px patches; SigLIP blocks (LayerNorm, biased attention
  within a tile, tanh-GELU MLP), learned positions with Idefics3's bucket
  quirk, a final LayerNorm; the pixel shuffle (4) and the connector; the
  SmolLM2 decoder (Llama: RMSNorm, grouped kv heads, causal, 1-D rotary).
- Both: the projection to 128 with a bias, l2-normalised, masked rows 0.
  Loss: MaxSim of every query with every page of the batch over the
  temperature, cross-entropy against the diagonal. Optimizer: global-norm
  clip 1.0 then AdamW (0.9, 0.999, 1e-8, decay 0.01) at a cosine schedule
  from ``lr`` over 10,000 steps, as optax's chain.

``precision="fp8"`` is the control, the step below bf16 that would tempt a
later change: every linear layer as fp8 training runs it, its input and
weight rounded to float8 e4m3 and, in the backward, the incoming gradient
to e5m2 (per-tensor scales), the products accumulated in f32.
"""

from __future__ import annotations

import contextlib
import hashlib
import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
PROMPT = "Describe the image."
EPS = 1e-6
NEG = -1e30


@contextlib.contextmanager
def exact_f32():
    """f32 matmuls without TF32 inside the block."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


# -- the processor ----------------------------------------------------------------


def prompt_ids(vocab: int) -> List[int]:
    """The page prompt's token ids: begin-of-text 1, then each lower-cased
    word's sha1 (first 4 bytes, little-endian) mod (vocab - 4), plus 4."""
    return [1] + [4 + int.from_bytes(hashlib.sha1(w.encode()).digest()[:4], "little")
                  % (vocab - 4) for w in PROMPT.lower().split()]


def _nearest(img: np.ndarray, h: int, w: int) -> np.ndarray:
    ys = np.clip((np.arange(h) * img.shape[0] / h).astype(int), 0, img.shape[0] - 1)
    xs = np.clip((np.arange(w) * img.shape[1] / w).astype(int), 0, img.shape[1] - 1)
    return img[ys][:, xs]


def _patches(canvas: np.ndarray, rows: int, cols: int, side: int) -> np.ndarray:
    """[rows * cols, side * side * 3], patches row-major, each patch's
    pixels row, column, channel."""
    c = canvas[:rows * side, :cols * side].reshape(rows, side, cols, side, 3)
    return c.transpose(0, 2, 1, 3, 4).reshape(rows * cols, side * side * 3)


def process_page(image: np.ndarray, cfg: Dict) -> Dict[str, np.ndarray]:
    """One page image (uint8 [H, W, 3]) -> patches [N, P] f32, segment ids
    [N] (windows or tiles; None where attention is over the whole page),
    the number of image tokens, and extra grid facts."""
    x = image.astype(np.float32) / 255.0
    if cfg["model_type"] == "qwen2_5_vl":
        v = cfg["vision_config"]
        x = (x - np.float32(CLIP_MEAN)) / np.float32(CLIP_STD)
        cap = cfg["max_visual_tokens"]
        aspect = x.shape[1] / x.shape[0]
        h = max(2, int(round((cap / aspect) ** 0.5)))
        w = max(2, int(round(aspect * h)))
        while h * w > cap:
            if w >= h and w > 2:
                w -= 1
            elif h > 2:
                h -= 1
            else:
                break
        gh, gw, ps = 2 * h, 2 * w, v["patch_size"]
        p = _patches(_nearest(x, gh * ps, gw * ps), gh, gw, ps)
        hp = np.repeat(np.arange(gh), gw).reshape(gh, gw)
        wp = np.tile(np.arange(gw), (gh, 1))

        def merge_order(a):
            return a.reshape(gh // 2, 2, gw // 2, 2).transpose(0, 2, 1, 3).reshape(-1)

        hp, wp = merge_order(hp), merge_order(wp)
        side = v["window_size"] // ps  # 8 patches
        win = (hp // side) * (-(-gw // side)) + wp // side
        return {"patches": p[hp * gw + wp], "segments": win.astype(np.int64),
                "n_image_tokens": h * w}
    v = cfg["vision_config"]
    x = (x - 0.5) / 0.5
    hh, ww = x.shape[0], x.shape[1]
    scale = min(1.0, 2048 / max(ww, hh))
    new_w, new_h = max(1, int(round(ww * scale))), max(1, int(round(hh * scale)))
    tile = v["image_size"]
    cols, rows = -(-new_w // tile), -(-new_h // tile)
    side = tile // v["patch_size"]
    canvas = _nearest(x, rows * tile, cols * tile)
    tiles = [_patches(canvas[r * tile:(r + 1) * tile, c * tile:(c + 1) * tile], side, side,
                      v["patch_size"]) for r in range(rows) for c in range(cols)]
    tiles.append(_patches(_nearest(x, tile, tile), side, side, v["patch_size"]))
    n_tiles = len(tiles)
    return {"patches": np.concatenate(tiles), "n_tiles": n_tiles, "rows": rows, "cols": cols,
            "segments": np.repeat(np.arange(n_tiles), side * side),
            "n_image_tokens": n_tiles * side * side // cfg["scale_factor"] ** 2}


# -- the model ----------------------------------------------------------------------


def _fp8(x: torch.Tensor, dtype=torch.float8_e4m3fn) -> torch.Tensor:
    """x rounded to an 8-bit float at a per-tensor scale to its largest
    value (448 for e4m3, 57344 for e5m2), in f32."""
    scale = x.abs().amax().clamp(min=1e-30) / torch.finfo(dtype).max
    return (x / scale).to(dtype).float() * scale


class _Fp8Linear(torch.autograd.Function):
    """x @ w.T as fp8 training computes it: x and w in e4m3, the incoming
    gradient in e5m2, each product accumulated in f32."""

    @staticmethod
    def forward(ctx, x, w):
        xq, wq = _fp8(x.detach()), _fp8(w.detach())
        ctx.save_for_backward(xq, wq)
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = _fp8(g, torch.float8_e5m2)
        return gq @ wq, gq.T @ xq


class Reference:
    """The plain model over a dict of f32 parameters (the program's names)."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], precision: str = "f32"):
        self.cfg, self.p, self.precision = cfg, params, precision
        self.qwen = cfg["model_type"] == "qwen2_5_vl"
        if self.qwen:
            v = cfg["vision_config"]
            self.v_heads, self.v_layers = v["num_heads"], v["depth"]
            self.full = set(v["fullatt_block_indexes"])
            t = cfg
        else:
            v, t = cfg["vision_config"], cfg["text_config"]
            self.v_heads, self.v_layers, self.full = (v["num_attention_heads"],
                                                      v["num_hidden_layers"], set())
        self.t_heads, self.t_kv = t["num_attention_heads"], t["num_key_value_heads"]
        self.t_layers, self.theta = t["num_hidden_layers"], t["rope_theta"]
        self.remat = False

    def lin(self, x, name: str, bias: bool = True):
        w = self.p[f"{name}.weight"]
        y = _Fp8Linear.apply(x, w) if self.precision == "fp8" else x @ w.T
        b = self.p.get(f"{name}.bias") if bias else None
        return y if b is None else y + b

    def rms(self, x, name):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + EPS) * self.p[f"{name}.scale"]

    def ln(self, x, name):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + EPS) * self.p[f"{name}.scale"] + self.p[f"{name}.bias"]

    @staticmethod
    def attend(q, k, v, seg: torch.Tensor, causal: bool):
        """q [T, H, Dh], k/v [T, Hkv, Dh]; a token attends its own segment
        (and, causal, the tokens before it). Contiguous segments one by one;
        others (windows) by a dense mask."""
        t, h, dh = q.shape
        rep = h // k.shape[1]
        k, v = k.repeat_interleave(rep, 1), v.repeat_interleave(rep, 1)
        scale = dh ** -0.5
        change = torch.nonzero(seg[1:] != seg[:-1]).flatten().tolist()
        bounds = [0] + [c + 1 for c in change] + [t]
        if len(bounds) - 1 == int(torch.unique(seg).numel()):  # contiguous segments
            outs = []
            for s, e in zip(bounds[:-1], bounds[1:]):
                logits = torch.einsum("qhd,khd->hqk", q[s:e], k[s:e]) * scale
                if causal:
                    logits = logits.masked_fill(
                        ~torch.ones((e - s, e - s), dtype=torch.bool, device=q.device).tril(),
                        NEG)
                outs.append(torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v[s:e]))
            return torch.cat(outs)
        ok = seg[:, None] == seg[None, :]
        if causal:
            ok = ok & torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
        logits = torch.einsum("qhd,khd->hqk", q, k) * scale
        logits = logits.masked_fill(~ok[None], NEG)
        return torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v)

    def rope(self, x, pos):
        half = x.shape[-1] // 2
        inv = 1.0 / (self.theta ** (torch.arange(half, dtype=torch.float32,
                                                 device=x.device) / half))
        ang = pos[:, None].float() * inv
        cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)

    def _block(self, fn, *args):
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False)
        return fn(*args)

    # vision -----------------------------------------------------------------

    def vit_block(self, i: int, x, seg):
        b = f"vision.blocks.{i}"
        t, hid = x.shape
        norm = self.rms if self.qwen else self.ln
        y = norm(x, f"{b}.ln1")
        dh = hid // self.v_heads
        q, k, v = (self.lin(y, f"{b}.attn.{m}").view(t, self.v_heads, dh) for m in "qkv")
        h = x + self.lin(self.attend(q, k, v, seg, False).reshape(t, hid), f"{b}.attn.o")
        y = norm(h, f"{b}.ln2")
        if self.qwen:
            y = self.lin(F.silu(self.lin(y, f"{b}.mlp.gate")) * self.lin(y, f"{b}.mlp.up"),
                         f"{b}.mlp.down")
        else:
            y = self.lin(F.gelu(self.lin(y, f"{b}.fc1"), approximate="tanh"), f"{b}.fc2")
        return h + y

    def image_tokens(self, patches, segments):
        """[N, P] patches (the page's valid ones) -> [N', text hidden]."""
        x = self.lin(patches, "vision.patch_embed", bias=not self.qwen)
        n = x.shape[0]
        if not self.qwen:
            side = int(round(self.p["vision.pos_embed"].shape[0] ** 0.5))
            bucket = (torch.arange(side, device=x.device) - 1).clamp(min=0)
            ids = (bucket[:, None] * side + bucket[None, :]).reshape(-1)
            x = x + self.p["vision.pos_embed"][ids[torch.arange(n, device=x.device) % ids.numel()]]
        whole = torch.zeros(n, dtype=torch.long, device=x.device)
        for i in range(self.v_layers):
            seg = whole if i in self.full else segments
            x = self._block(self.vit_block, i, x, seg)
        if self.qwen:
            x = self.rms(x, "merger.ln_q").reshape(n // 4, -1)
            return self.lin(F.gelu(self.lin(x, "merger.fc1"), approximate="tanh"), "merger.fc2")
        x = self.ln(x, "vision.post_ln")
        s = self.cfg["scale_factor"]
        side = int(round(self.p["vision.pos_embed"].shape[0] ** 0.5))
        tiles, h = n // (side * side), x.shape[1]
        x = x.reshape(tiles, side, side // s, h * s).permute(0, 2, 1, 3)
        x = x.reshape(tiles, side // s, side // s, h * s * s).permute(0, 2, 1, 3)
        return self.lin(x.reshape(tiles * (side // s) ** 2, h * s * s), "connector", bias=False)

    # text -------------------------------------------------------------------

    def dec_block(self, i: int, x, pos):
        b = f"layers.{i}"
        t, hid = x.shape
        dh = hid // self.t_heads
        y = self.rms(x, f"{b}.ln1")
        q = self.rope(self.lin(y, f"{b}.attn.q").view(t, self.t_heads, dh), pos)
        k = self.rope(self.lin(y, f"{b}.attn.k").view(t, self.t_kv, dh), pos)
        v = self.lin(y, f"{b}.attn.v").view(t, self.t_kv, dh)
        seg = torch.zeros(t, dtype=torch.long, device=x.device)
        h = x + self.lin(self.attend(q, k, v, seg, True).reshape(t, hid), f"{b}.attn.o",
                         bias=False)
        y = self.rms(h, f"{b}.ln2")
        return h + self.lin(F.silu(self.lin(y, f"{b}.mlp.gate", False))
                            * self.lin(y, f"{b}.mlp.up", False), f"{b}.mlp.down", False)

    def embed(self, ids: torch.Tensor, image: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The valid tokens' [L, 128] l2-normalised embeddings of one sequence
        (ids of its valid tokens only; image tokens filled in order)."""
        x = self.p["tok_embed.weight"][ids]
        if image is not None:
            is_img = ids == self.cfg["image_token_id"]
            x = x.clone()
            x[is_img] = image[:int(is_img.sum())]
        pos = torch.arange(ids.shape[0], device=ids.device)
        for i in range(self.t_layers):
            x = self._block(self.dec_block, i, x, pos)
        e = self.lin(self.rms(x, "final_norm"), "proj")
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)

    def page(self, page: Dict, device) -> torch.Tensor:
        patches = torch.from_numpy(page["patches"]).to(device)
        segments = torch.from_numpy(page["segments"]).to(device)
        image = self.image_tokens(patches, segments)
        ids = torch.tensor([self.cfg["image_token_id"]] * page["n_image_tokens"]
                           + prompt_ids(self.vocab), device=device)
        return self.embed(ids, image)

    @property
    def vocab(self) -> int:
        return self.p["tok_embed.weight"].shape[0]


# -- training -----------------------------------------------------------------------


def embedding_gap(got: Sequence[np.ndarray], want: Sequence[np.ndarray]) -> float:
    """The largest L2 distance between a row and the reference's; a sequence
    missing or of another length reads infinite."""
    if len(got) != len(want):
        return float("inf")
    gap = 0.0
    for a, b in zip(got, want):
        if a.shape != b.shape:
            return float("inf")
        gap = max(gap, float(np.max(np.linalg.norm(a - b, axis=-1))))
    return gap


def infonce(q_embs: Sequence[torch.Tensor], p_embs: Sequence[torch.Tensor],
            temperature: float) -> torch.Tensor:
    scores = torch.stack([torch.stack([(q @ p.T).amax(1).sum() for p in p_embs])
                          for q in q_embs])
    return F.cross_entropy(scores / temperature, torch.arange(len(q_embs),
                                                               device=scores.device))


def cosine_lr(lr: float, step: int, decay_steps: int = 10_000) -> float:
    count = min(step, decay_steps)
    return float(np.float32(lr * 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))))


def train_steps(cfg: Dict, params: Dict[str, torch.Tensor], batches: Sequence[Dict],
                lr: float, temperature: float, precision: str = "f32",
                fault: Optional[str] = None) -> Dict:
    """Steps of the reference over ``batches`` (each {"pages": [processed
    pages], "queries": [id arrays]}), updating ``params`` in place. Returns
    the loss of each step, step 1's embeddings (the queries', then the
    pages', valid rows only) and each leaf's gradient norm at step 1 (after
    the clip, as the optimizer takes it).

    Each step embeds every query and page without grad, takes the loss's
    gradient with respect to the embeddings, then runs each sequence's
    forward again with grad and pushes that gradient through it, so one
    sequence's activations are held at a time (each block recomputed in the
    backward).

    ``fault`` plants one of the faults the check must catch, to read it:
    ``"half_batch"`` (the loss over the first half of the pairs only) or
    ``"token_altered"`` (the first query's first token embedding negated
    where it is produced)."""
    device = next(iter(params.values())).device
    for t in params.values():
        t.requires_grad_(True)
    model = Reference(cfg, params, precision)
    mu = {k: torch.zeros_like(v) for k, v in params.items()}
    nu = {k: torch.zeros_like(v) for k, v in params.items()}
    b1, b2, eps, wd = 0.9, 0.999, 1e-8, 0.01
    out = {"loss": [], "grad_norms": {}}
    with exact_f32():
        for n, batch in enumerate(batches):
            qs = [torch.from_numpy(q).to(device) for q in batch["queries"]]
            pages = batch["pages"]
            if fault == "half_batch":
                qs, pages = qs[:max(2, len(qs) // 2)], pages[:max(2, len(pages) // 2)]
            embed = model.embed
            if fault == "token_altered":
                def embed(q, image=None, first=qs[0]):
                    e = model.embed(q, image)
                    return torch.cat([-e[:1], e[1:]]) if q is first else e
            with torch.no_grad():
                q_e = [embed(q) for q in qs]
                p_e = [model.page(pg, device) for pg in pages]
            if n == 0:
                out["embeddings"] = [e.cpu().double().numpy() for e in q_e + p_e]
            q_e = [e.requires_grad_(True) for e in q_e]
            p_e = [e.requires_grad_(True) for e in p_e]
            loss = infonce(q_e, p_e, temperature)
            loss.backward()
            out["loss"].append(float(loss.detach()))
            model.remat = True
            for q, e in zip(qs, q_e):
                embed(q).backward(e.grad)
            for pg, e in zip(pages, p_e):
                model.page(pg, device).backward(e.grad)
            model.remat = False
            with torch.no_grad():
                grads = {k: (v.grad if v.grad is not None else torch.zeros_like(v))
                         for k, v in params.items()}
                norm = torch.sqrt(sum(g.double().square().sum() for g in grads.values()))
                clip = float(norm) >= 1.0
                step_lr = cosine_lr(lr, n)
                bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(n + 1))
                bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(n + 1))
                for k, p in params.items():
                    g = grads[k] / float(norm) if clip else grads[k]
                    if n == 0:
                        out["grad_norms"][k] = float(torch.linalg.vector_norm(g.double()))
                    mu[k].mul_(b1).add_((1 - b1) * g)
                    nu[k].mul_(b2).add_((1 - b2) * g * g)
                    upd = (mu[k] / bc1) / (torch.sqrt(nu[k] / bc2) + eps) + wd * p
                    p.sub_(step_lr * upd)
                    p.grad = None
    for t in params.values():
        t.requires_grad_(False)
    return out


def rounding_leaves(grads: Dict[str, float], share: float = 1e-3) -> List[str]:
    """Leaves whose reference gradient is under ``share`` of the median
    leaf's: zero but for rounding (a key's bias under the softmax), so any
    change of theirs is round-off moved by Adam's normalisation."""
    med = float(np.median(list(grads.values())))
    return sorted(k for k, v in grads.items() if v < share * med)


def leaf_gaps(got: Dict[str, float], want: Dict[str, float],
              skip: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |got - want| of its norm over the larger of want's norm
    and the median leaf's, the leaves in ``skip`` left out."""
    med = float(np.median(list(want.values())))
    return {k: abs(got[k] - w) / max(w, med) for k, w in want.items() if k not in skip}


# -- page vectors (ingest) ---------------------------------------------------------


def page_vectors(emb: torch.Tensor, page: Dict) -> Dict[str, np.ndarray]:
    """The reference's vectors of one Idefics3 page: the image tokens'
    rows, the mean of each tile's 64 rows, the tile means of all tiles but
    the global one followed by the global tile's rows, and the mean of the
    tile means."""
    n_img = page["n_image_tokens"]
    rows = emb[:n_img].double().cpu().numpy()
    tiles = rows.reshape(page["n_tiles"], -1, rows.shape[1])
    mean = tiles.mean(1)
    return {"initial": rows, "mean_pooling": mean,
            "experimental_pooling": np.concatenate([mean[:-1], tiles[-1]]),
            "global_pooling": mean.mean(0, keepdims=True)}
