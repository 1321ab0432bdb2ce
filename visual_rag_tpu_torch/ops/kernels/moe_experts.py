"""The routed experts of a sigmoid-routed MoE layer, grouped by expert (K11).

New in the port: the JAX package's only expert layer is its softmax MoE with
a capacity (``visual_rag_tpu/models/moe.py``, refused by the port, ROADMAP
A9), so K11 replaces no TPU kernel. It runs Kimi-VL's (DeepSeek-V3's)
routed experts: each token's ``top_k`` experts, each a SwiGLU ``down(silu(
gate x) * up x)``, their outputs weighted by the router and added to the
shared experts' output. No token is dropped.

- :func:`expert_layout` sorts the (token, expert) pairs by expert on the
  device: the sorted rows' tokens, each expert's offset into them, each
  expert's first tile of ``BLOCK_M`` rows (an expert's rows padded to whole
  tiles), and where each pair landed. It reads nothing back to the host:
  the counts are a ``scatter_add`` and the offsets cumulative sums, so a
  forward through it never synchronises.
- :func:`moe_experts` on CUDA bf16 tensors launches ``csrc/moe_experts.cu``
  (three kernels, counted as one call in ``moe_experts.launches``): the gate
  and up projections in one pass over each tile's rows, SiLU x up applied
  in the epilogue (``h``, bf16); the down projection (``y``, bf16); then each
  token's ``top_k`` rows of y times their weights, summed in f32 in slot
  order onto the shared experts' output. The sum is in a fixed order, so
  two calls give the same bits. On CPU tensors it runs
  :func:`moe_experts_plain`, a loop of torch matmuls over the same sorted
  layout with the kernel's roundings (f32 products, h and y rounded to the
  compute dtype). It raises on CUDA inputs the kernel does not take.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import on_cpu, ptr, stream_ptr

BLOCK_M = 64  # sorted rows a tile (csrc/moe_experts.cu MOE_BM)
GATE_UP_N = 64  # columns of h a block, per matrix (MOE_BN / 2)
DOWN_N = 128  # columns of y a block (MOE_BN)
BLOCK_K = 32  # depth a pipeline stage (MOE_BK)


class ExpertLayout(NamedTuple):
    """The (token, expert) pairs of a layer sorted by expert. ``tokens``
    [P] int32: the token of each sorted row (P = tokens x top_k);
    ``offsets`` [E + 1] int32: expert e's rows are ``offsets[e]`` to
    ``offsets[e + 1]``; ``tile_starts`` [E + 1] int32: expert e's first tile
    of ``BLOCK_M`` rows; ``slots`` [T, top_k] int32: the sorted row of each
    pair; ``counts`` [E] int32: the rows each expert takes."""

    tokens: torch.Tensor
    offsets: torch.Tensor
    tile_starts: torch.Tensor
    slots: torch.Tensor
    counts: torch.Tensor

    @property
    def max_tiles(self) -> int:
        """A bound on the tiles, from host-known sizes: ceil(P / BLOCK_M) + E
        (each expert's last tile may be part full)."""
        return -(-self.tokens.numel() // BLOCK_M) + self.counts.numel()


def expert_layout(experts: torch.Tensor, n_experts: int) -> ExpertLayout:
    """The layout of ``experts`` [T, top_k] (each token's chosen experts) on
    their device, by a stable sort: an expert's rows keep the tokens'
    order."""
    t, k = experts.shape
    flat = experts.reshape(-1)
    order = torch.sort(flat, stable=True).indices
    ones = torch.ones_like(flat, dtype=torch.int32)
    counts = torch.zeros(n_experts, dtype=torch.int32, device=flat.device).scatter_add_(
        0, flat, ones)
    zero = torch.zeros(1, dtype=torch.int32, device=flat.device)
    offsets = torch.cat([zero, torch.cumsum(counts, 0, dtype=torch.int32)])
    tiles = torch.div(counts + (BLOCK_M - 1), BLOCK_M, rounding_mode="floor")
    tile_starts = torch.cat([zero, torch.cumsum(tiles, 0, dtype=torch.int32)])
    slots = torch.empty_like(flat, dtype=torch.int32)
    slots[order] = torch.arange(t * k, dtype=torch.int32, device=flat.device)
    tokens = torch.div(order, k, rounding_mode="floor").to(torch.int32)
    return ExpertLayout(tokens, offsets, tile_starts, slots.view(t, k), counts)


def _check(x, gate, up, down, layout: ExpertLayout, weights, base) -> None:
    t, hidden = x.shape
    e, inter, h_in = gate.shape
    if up.shape != gate.shape or down.shape != (e, hidden, inter) or h_in != hidden:
        raise ValueError(f"expert weights gate {tuple(gate.shape)}, up {tuple(up.shape)}, "
                         f"down {tuple(down.shape)} do not fit x {tuple(x.shape)}")
    if weights.shape != layout.slots.shape or weights.shape[0] != t:
        raise ValueError(f"weights {tuple(weights.shape)} do not fit the layout "
                         f"{tuple(layout.slots.shape)} of {t} tokens")
    if layout.counts.numel() != e:
        raise ValueError(f"the layout routes to {layout.counts.numel()} experts, not {e}")
    if base is not None and base.shape != x.shape:
        raise ValueError(f"base {tuple(base.shape)} does not fit x {tuple(x.shape)}")


def _check_kernel_inputs(x, gate, up, down, layout: ExpertLayout, weights, base) -> None:
    """What K11 takes: bf16 activations and weights, contiguous; widths in
    whole tiles; f32 weights; int32 layout; one device."""
    t, hidden = x.shape
    inter = gate.shape[1]
    tensors = [("x", x), ("gate", gate), ("up", up), ("down", down)]
    if base is not None:
        tensors.append(("base", base))
    for name, a in tensors:
        if a.dtype != torch.bfloat16 or not a.is_contiguous() or a.data_ptr() % 16:
            raise ValueError(f"K11 takes contiguous, 16-byte aligned bf16 tensors; {name} is "
                             f"{a.dtype}{'' if a.is_contiguous() else ', not contiguous'}")
    if hidden % DOWN_N or inter % GATE_UP_N or hidden % BLOCK_K or inter % BLOCK_K:
        raise ValueError(f"K11 takes hidden a multiple of {DOWN_N} and expert width a multiple "
                         f"of {GATE_UP_N}, got {hidden} and {inter}")
    if weights.dtype != torch.float32 or not weights.is_contiguous():
        raise ValueError("weights must be a contiguous f32 [T, top_k] tensor")
    for name, a in zip(layout._fields, layout):
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise ValueError(f"layout.{name} must be a contiguous int32 tensor")
    for name, a in tensors[1:] + [("weights", weights)] + list(zip(layout._fields, layout)):
        if a.device != x.device:
            raise ValueError(f"{name} is on {a.device}, x on {x.device}")
    if layout.max_tiles > 2**31 - 1 or max(inter // GATE_UP_N, hidden // DOWN_N) > 65535:
        raise ValueError(f"K11 does not take {t} tokens at hidden {hidden}, width {inter}")


def moe_experts(x: torch.Tensor, gate: torch.Tensor, up: torch.Tensor, down: torch.Tensor,
                layout: ExpertLayout, weights: torch.Tensor,
                base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[T, hidden] in x's dtype: ``base`` (0 without it) plus, for each token,
    the sum over its pairs j of ``weights[t, j] * down_e(silu(gate_e x) *
    up_e x)``, e its j-th expert. x [T, hidden]; gate, up [E, width,
    hidden]; down [E, hidden, width]; ``layout`` of the tokens' experts
    (:func:`expert_layout`); weights [T, top_k] f32 (module docstring)."""
    _check(x, gate, up, down, layout, weights, base)
    if on_cpu(x):
        return moe_experts_plain(x, gate, up, down, layout, weights, base)
    _check_kernel_inputs(x, gate, up, down, layout, weights, base)
    t, hidden = x.shape
    e, inter, _ = gate.shape
    k = layout.slots.shape[1]
    h = torch.empty((t * k, inter), dtype=x.dtype, device=x.device)
    y = torch.empty((t * k, hidden), dtype=x.dtype, device=x.device)
    out = torch.empty_like(x)
    if t == 0:
        return out
    lib = _build.load_library()
    err = lib.vrt_moe_experts(
        x.device.index, ptr(x), ptr(gate), ptr(up), ptr(down), ptr(layout.tokens),
        ptr(layout.offsets), ptr(layout.tile_starts), ptr(layout.slots), ptr(weights), ptr(base),
        t, k, e, hidden, inter, layout.max_tiles, ptr(h), ptr(y), ptr(out), stream_ptr(x.device))
    _build.check(err, "moe_experts launch")
    moe_experts.launches += 1
    return out


moe_experts.launches = 0


def moe_experts_plain(x, gate, up, down, layout: ExpertLayout, weights,
                      base=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`moe_experts` over the same sorted
    layout: each expert's rows through f32 matmuls of the stored values, h
    and y rounded to x's dtype as the kernel stores them, then each token's
    rows weighted and summed in f32 in slot order onto ``base``."""
    t, hidden = x.shape
    k = layout.slots.shape[1]
    dt = x.dtype
    y = torch.zeros((t * k, hidden), dtype=dt, device=x.device)
    off = layout.offsets.tolist()
    for e in range(gate.shape[0]):
        s, end = off[e], off[e + 1]
        if s == end:
            continue
        rows = x[layout.tokens[s:end].long()].float()
        g = rows @ gate[e].float().T
        u = rows @ up[e].float().T
        h = (F.silu(g) * u).to(dt)
        y[s:end] = (h.float() @ down[e].float().T).to(dt)
    acc = (torch.zeros((t, hidden), dtype=torch.float32, device=x.device) if base is None
           else base.float())
    picked = y[layout.slots.long()].float()  # [T, top_k, hidden]
    for j in range(k):
        acc = acc + weights[:, j, None].float() * picked[:, j]
    return acc.to(dt)
