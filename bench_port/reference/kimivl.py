"""Plain reference of Kimi-VL-A3B-Instruct under ColQwen's retrieval head:
the processor, the forward pass of a page, and the page vectors.

Plain PyTorch in f32 (TF32 off), one page at a time, with no kernel, cache
or batching; it imports nothing of the program (only the shared helpers of
``reference/colvlm.py``). Written from the published architecture
(moonshotai/Kimi-VL-A3B-Instruct's config.json and modeling code; the
technical report, arXiv:2504.07491) as the configuration file states it:

- the processor: the page scaled by one factor so that (W // 14) *
  (H // 14) <= ``in_token_limit`` patches, padded at the bottom and right to
  multiples of 28 px with black, normalised by mean = std = 0.5; patches of
  14 x 14 x 3 in the grid's row-major order, MoonViT's own;
- MoonViT: a biased linear over each patch's 588 values; the learned 64 x 64
  position table interpolated bicubically (``align_corners=False``) to the
  page's grid; 27 blocks of LayerNorm (eps 1e-5), biased q/k/v/out attention
  over the whole image with the 2-D rotary (head dim 72 as 36 complex pairs:
  pair 2m turns by ``col * theta ** (-4m / 72)``, pair 2m + 1 by ``row *`` the
  same, theta 10000) applied by complex multiplication, and a biased
  tanh-GELU MLP; a final LayerNorm;
- the 2 x 2 merge (each 2 x 2 block of the grid, row-major inside, one row
  of 4 x 1152) and the projector: LayerNorm (eps 1e-5) on each patch, then
  4608 -> 4608, exact GELU, 4608 -> 2048, all biased;
- the DeepSeek-V3 decoder: RMSNorm (eps 1e-5); multi-head latent attention
  without a q LoRA in its un-absorbed form (q [16, 128 + 64]; a latent of 512
  RMS-normed with the norm's own eps 1e-6 and up-projected to each head's
  128-wide nope key and value; one 64-wide rope key shared by the heads; the
  rotary on pairs (2i, 2i + 1) by complex multiplication, theta 800000;
  logits ``(q_nope . k_nope + q_pe . k_pe) / sqrt(192)``, causal); layer 0's
  dense SwiGLU of 11264; layers 1-26: the router (f32 sigmoid scores of a
  bias-free linear; the top 6 of score + ``e_score_correction_bias``; weights
  the chosen raw scores over their sum plus 1e-20, times 2.446), 64 routed
  SwiGLU experts 1408 wide and the 2 shared as one SwiGLU 2816 wide, no
  token dropped; the final RMSNorm;
- ColQwen's head: a biased linear to 128, l2-normalised; the image tokens'
  rows are the page's embeddings, pooled as ColQwen2.5's pages (row means
  of the merged grid in adaptive bins to at most 32 rows, a same-length
  gaussian smoothing of window 3, their mean).

Departures, each also in the configuration file where it concerns the
program: the page is resized nearest-neighbour (the published processor
resizes bicubically); the fused ``wqkv`` is three matrices; a patch's 588
values are (row, column, channel) where the published Conv2d reads
(channel, row, column): with random weights these are relabelings. The
routed layer is computed densely, as DeepSeek-V3's report writes it: every
expert over every token, each token's outputs summed under its gate values,
which are its chosen experts' weights and 0 for the rest. That is the
per-token sum over the chosen experts with no sort, gather or grouping of
tokens (the program's layout), at 64 / 6 times the routed experts' FLOPs.

``precision="fp8"`` is the control: every linear layer but the router's
(which stays f32, as an fp8 deployment keeps it) with its input and weight
rounded to float8 e4m3 at per-tensor scales (``reference/colvlm.py``).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from bench_port.reference import colvlm
from bench_port.reference.colvlm import (  # noqa: F401  (exact_f32 is the contract's)
    _Fp8Linear, _nearest, _patches, exact_f32)

NEG = -1e30
# the media markers around a page's placeholders (<|media_pad|>, the
# configuration's media_placeholder_token_id): Kimi-VL's tokenizer's
# <|media_start|> and <|media_content|> before, <|media_end|> after
MEDIA_START, MEDIA_CONTENT, MEDIA_END = 163602, 163603, 163604


# -- the processor ----------------------------------------------------------------


def process_page(image: np.ndarray, cfg: Dict) -> Dict:
    """One page image (uint8 [H, W, 3]) -> patches [N, 588] f32 in row-major
    grid order, its ``grid`` (rows, cols), one segment (attention over the
    whole image) and the number of image tokens."""
    v = cfg["vision_config"]
    ps, (mh, mw) = v["patch_size"], v["merge_kernel_size"]
    x = (image.astype(np.float32) / 255.0 - 0.5) / 0.5
    h, w = x.shape[0], x.shape[1]
    limit = cfg["in_token_limit"]
    if (w // ps) * (h // ps) > limit:
        scale = math.sqrt(limit / ((w // ps) * (h // ps)))
        x = _nearest(x, int(h * scale), int(w * scale))
    gh = -(-x.shape[0] // (mh * ps)) * mh
    gw = -(-x.shape[1] // (mw * ps)) * mw
    canvas = np.full((gh * ps, gw * ps, 3), -1.0, np.float32)
    canvas[: x.shape[0], : x.shape[1]] = x
    n = gh * gw
    return {"patches": _patches(canvas, gh, gw, ps), "grid": (gh, gw),
            "segments": np.zeros(n, np.int64), "n_image_tokens": n // (mh * mw)}


def prompt_ids(vocab: int) -> List[int]:
    """A page's token ids besides its placeholders: the three media markers
    and the page prompt (``reference/colvlm.py``'s)."""
    return [MEDIA_START, MEDIA_CONTENT, MEDIA_END] + colvlm.prompt_ids(vocab)


def page_ids(cfg: Dict, n_image_tokens: int, vocab: int) -> List[int]:
    """The page's token ids: the media markers around its placeholders, then
    the page prompt."""
    return ([MEDIA_START, MEDIA_CONTENT] + [cfg["media_placeholder_token_id"]] * n_image_tokens
            + [MEDIA_END] + colvlm.prompt_ids(vocab))


# -- the model ----------------------------------------------------------------------


class Reference:
    """The plain model over a dict of f32 parameters (the program's names)."""

    def __init__(self, cfg: Dict, params: Dict[str, torch.Tensor], precision: str = "f32"):
        self.cfg, self.p, self.precision = cfg, params, precision
        v = cfg["vision_config"]
        self.v_heads, self.v_layers = v["num_attention_heads"], v["num_hidden_layers"]
        self.t_heads, self.t_layers = cfg["num_attention_heads"], cfg["num_hidden_layers"]
        self.eps = cfg["rms_norm_eps"]

    def mm(self, x, w):
        return _Fp8Linear.apply(x, w) if self.precision == "fp8" else x @ w.T

    def lin(self, x, name: str):
        y = self.mm(x, self.p[f"{name}.weight"])
        b = self.p.get(f"{name}.bias")
        return y if b is None else y + b

    def ln(self, x, name: str, eps: float = 1e-5):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) * torch.rsqrt(var + eps) * self.p[f"{name}.scale"] + self.p[f"{name}.bias"]

    def rms(self, x, name: str, eps: float):
        return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * self.p[f"{name}.scale"]

    @staticmethod
    def rotate(x, angles):
        """x [T, H, d] as d / 2 complex pairs (2i, 2i + 1), each times
        exp(i angles[T, d / 2])."""
        xc = torch.view_as_complex(x.reshape(*x.shape[:-1], -1, 2).contiguous())
        cis = torch.polar(torch.ones_like(angles), angles)[:, None, :]
        return torch.view_as_real(xc * cis).reshape(x.shape)

    @staticmethod
    def attend(q, k, v, causal: bool):
        """q, k [T, H, dk], v [T, H, dv]; every key of the image, or the
        keys up to the row (causal); scale 1 / sqrt(dk)."""
        logits = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(q.shape[-1])
        if causal:
            t = q.shape[0]
            allowed = torch.ones((t, t), dtype=torch.bool, device=q.device).tril()
            logits = logits.masked_fill(~allowed, NEG)
        return torch.einsum("hqk,khd->qhd", torch.softmax(logits, -1), v)

    # vision -----------------------------------------------------------------

    def positions(self, grid) -> torch.Tensor:
        table = self.p["vision.pos_embed"].permute(2, 0, 1)[None]
        out = F.interpolate(table, size=tuple(grid), mode="bicubic", align_corners=False)
        return out[0].permute(1, 2, 0).reshape(grid[0] * grid[1], -1)

    def vit_block(self, i: int, x, angles):
        b = f"vision.blocks.{i}"
        n, hid = x.shape
        dh = hid // self.v_heads
        y = self.ln(x, f"{b}.ln1")
        q, k, v = (self.lin(y, f"{b}.attn.{m}").view(n, self.v_heads, dh) for m in "qkv")
        q, k = self.rotate(q, angles), self.rotate(k, angles)
        h = x + self.lin(self.attend(q, k, v, causal=False).reshape(n, hid), f"{b}.attn.o")
        y = self.ln(h, f"{b}.ln2")
        return h + self.lin(F.gelu(self.lin(y, f"{b}.fc1"), approximate="tanh"), f"{b}.fc2")

    def image_tokens(self, patches, grid) -> torch.Tensor:
        """[N, 588] row-major patches of a (rows, cols) grid -> [N / 4, 2048]."""
        gh, gw = grid
        x = self.lin(patches, "vision.patch_embed") + self.positions(grid)
        dh = x.shape[1] // self.v_heads
        theta = self.cfg["vision_config"]["rope_theta"]
        inv = theta ** (-torch.arange(0, dh, 4, dtype=torch.float32, device=x.device)[: dh // 4]
                        / dh)
        rows = torch.arange(gh, device=x.device).repeat_interleave(gw).float()
        cols = torch.arange(gw, device=x.device).repeat(gh).float()
        angles = torch.stack([cols[:, None] * inv, rows[:, None] * inv], -1).reshape(gh * gw, -1)
        for i in range(self.v_layers):
            x = self.vit_block(i, x, angles)
        x = self.ln(x, "vision.post_ln")
        c = x.shape[1]
        x = x.reshape(gh // 2, 2, gw // 2, 2, c).permute(0, 2, 1, 3, 4).reshape(-1, 4, c)
        x = self.ln(x, "merger.ln_q").reshape(-1, 4 * c)
        return self.lin(F.gelu(self.lin(x, "merger.fc1")), "merger.fc2")

    # text -------------------------------------------------------------------

    def mla(self, i: int, x, angles):
        b = f"layers.{i}.attn"
        t = x.shape[0]
        nope, rope = self.cfg["qk_nope_head_dim"], self.cfg["qk_rope_head_dim"]
        rank, dv, h = self.cfg["kv_lora_rank"], self.cfg["v_head_dim"], self.t_heads
        q = self.lin(x, f"{b}.q").view(t, h, nope + rope)
        kv_a = self.lin(x, f"{b}.kv_a")
        kv = self.lin(self.rms(kv_a[:, :rank], f"{b}.kv_norm", 1e-6), f"{b}.kv_b").view(
            t, h, nope + dv)
        q_pe = self.rotate(q[..., nope:], angles)
        k_pe = self.rotate(kv_a[:, None, rank:], angles).expand(t, h, rope)
        qk = torch.cat([q[..., :nope], q_pe], -1)
        kk = torch.cat([kv[..., :nope], k_pe], -1)
        out = self.attend(qk, kk, kv[..., nope:], causal=True)
        return self.lin(out.reshape(t, h * dv), f"{b}.o")

    def swiglu(self, x, name: str):
        return self.lin(F.silu(self.lin(x, f"{name}.gate")) * self.lin(x, f"{name}.up"),
                        f"{name}.down")

    def route(self, i: int, x):
        """(experts [T, 6], weights [T, 6]) of layer ``i``'s tokens."""
        b = f"layers.{i}.mlp.router"
        scores = torch.sigmoid(x @ self.p[f"{b}.weight"].T)
        idx = torch.topk(scores + self.p[f"{b}.bias"], self.cfg["num_experts_per_tok"]).indices
        w = scores.gather(1, idx)
        if self.cfg["norm_topk_prob"]:
            w = w / (w.sum(-1, keepdim=True) + 1e-20)
        return idx, w * self.cfg["routed_scaling_factor"]

    def moe(self, i: int, x):
        """The routed experts beside the shared ones: token t's output is the
        shared experts' plus the sum over every expert e of g[t, e] times e's
        SwiGLU of x[t], g the token's gate values (its chosen experts'
        weights, 0 elsewhere)."""
        b = f"layers.{i}.mlp"
        idx, w = self.route(i, x)
        gate, up, down = (self.p[f"{b}.experts.{m}.weight"] for m in ("gate", "up", "down"))
        g = torch.zeros((x.shape[0], gate.shape[0]), device=x.device).scatter(1, idx, w)
        out = self.swiglu(x, f"{b}.shared")
        for e in range(gate.shape[0]):
            ye = self.mm(F.silu(self.mm(x, gate[e])) * self.mm(x, up[e]), down[e])
            out = out + g[:, e, None] * ye
        return out

    def dec_block(self, i: int, x, angles):
        h = x + self.mla(i, self.rms(x, f"layers.{i}.ln1", self.eps), angles)
        y = self.rms(h, f"layers.{i}.ln2", self.eps)
        if i < self.cfg["first_k_dense_replace"]:
            return h + self.swiglu(y, f"layers.{i}.mlp")
        return h + self.moe(i, y)

    def embed(self, ids: torch.Tensor, image: torch.Tensor) -> torch.Tensor:
        """The valid tokens' [L, 128] l2-normalised embeddings of one page
        (image tokens filled in order)."""
        x = self.p["tok_embed.weight"][ids].clone()
        x[ids == self.cfg["media_placeholder_token_id"]] = image
        rope = self.cfg["qk_rope_head_dim"]
        inv = self.cfg["rope_theta"] ** (
            -torch.arange(0, rope, 2, dtype=torch.float32, device=ids.device) / rope)
        angles = torch.arange(ids.shape[0], device=ids.device).float()[:, None] * inv
        for i in range(self.t_layers):
            x = self.dec_block(i, x, angles)
        e = self.lin(self.rms(x, "final_norm", self.eps), "proj")
        return e / (torch.linalg.vector_norm(e, dim=-1, keepdim=True) + 1e-8)

    def page(self, page: Dict, device) -> torch.Tensor:
        """The page's rows: its image tokens' embeddings first (the markers'
        and the prompt's rows dropped)."""
        image = self.image_tokens(torch.from_numpy(page["patches"]).to(device), page["grid"])
        ids = page_ids(self.cfg, page["n_image_tokens"], self.vocab)
        emb = self.embed(torch.tensor(ids, device=device), image)
        start = 2
        return emb[start:start + page["n_image_tokens"]]

    @property
    def vocab(self) -> int:
        return self.p["tok_embed.weight"].shape[0]


# -- page vectors (ingest) ---------------------------------------------------------


def _adaptive_bins(h: int, target: int) -> np.ndarray:
    """[target, h]: each bin the mean of rows floor(i h / target) to
    ceil((i + 1) h / target), clipped to at least one row."""
    edges = np.linspace(0, h, target + 1)
    w = np.zeros((target, h))
    for i in range(target):
        s = max(0, min(int(np.floor(edges[i])), h - 1))
        e = max(s + 1, min(int(np.ceil(edges[i + 1])), h))
        w[i, s:e] = 1.0 / (e - s)
    return w


def _gaussian_same_length(n: int) -> np.ndarray:
    """[n, n]: window 3 centred on each row, weights exp(-2 d^2) (sigma
    0.5), renormalised over the rows in range."""
    base = np.exp(-0.5 * (np.abs(np.arange(3) - 1.0) / 0.5) ** 2)
    w = np.zeros((n, n))
    for i in range(n):
        js = np.arange(i - 1, i + 2)
        ok = (js >= 0) & (js < n)
        w[i, js[ok]] = base[ok] / base[ok].sum()
    return w if n > 1 else np.eye(n)


def page_vectors(emb: torch.Tensor, page: Dict) -> Dict[str, np.ndarray]:
    """The stored vectors of one page: the image tokens' rows (in the merged
    grid's row-major order), the row means of that grid in adaptive bins to
    at most 32 rows, their same-length gaussian smoothing, and the mean of
    the binned rows."""
    gh, gw = page["grid"][0] // 2, page["grid"][1] // 2
    rows = emb[: gh * gw].double().cpu().numpy()
    means = rows.reshape(gh, gw, -1).mean(1)
    target = min(32, gh)
    binned = means if target == gh else _adaptive_bins(gh, target) @ means
    return {"initial": rows, "mean_pooling": binned,
            "experimental_pooling": _gaussian_same_length(binned.shape[0]) @ binned,
            "global_pooling": binned.mean(0, keepdims=True)}
