"""Flash attention with segment ids: the forward (K10) and its backward (B4, B5).

Counterpart of the library kernel that ``visual_rag_tpu/models/attention.py``
calls (``:61-73``): ``jax/experimental/pallas/ops/tpu/flash_attention.py``,
forward ``_flash_attention_impl`` (``pallas_call`` at ``:758``) with the
semantics of its ``mha_reference`` (``:1530``), and the two backward kernels
that ``jax.grad`` reaches through its ``custom_vjp``: B4
``_flash_attention_bwd_dkv`` (``:1121``) and B5 ``_flash_attention_bwd_dq``
(``:1456``), with the function of ``mha_reference_bwd`` (``:1615-1676``).

Layout is the JAX package's ``mha`` layout, ``[B, T, H, Dh]``; k and v may
carry fewer heads than q (head h reads kv head ``h // (Hq // Hkv)``), so
grouped-query attention never repeats them in memory. Key j is allowed for
row i when ``seg[b, j] == seg[b, i]`` and, under ``causal``, ``j <= i``; a
pad query (segment 0) attends the pad keys. Logits, maxima and sums are f32,
the output is in the input dtype, and a row with no allowed key is zeros.

- :func:`flash_attention` is differentiable. Without grad (or with inputs
  that need none) it is the serving call: on a CUDA tensor it launches
  ``csrc/flash_attention.cu`` (f32 or bf16, ``Dh`` 64, 72, 80, 128 or 256:
  ColSmol-500M's two towers, ColPali's vision tower and its Gemma text
  model, ColQwen2.5's vision tower and its Qwen2.5 text model) or raises; on
  a CPU tensor it runs :func:`flash_attention_plain`, which takes any
  ``Dh``. With grad it runs :class:`FlashAttentionFn`: the forward that
  also writes each row's logsumexp ``lse = m + log(l)`` (f32 ``[B, Hq, T]``,
  ``-inf`` for a row with no allowed key), then in the backward ``di =
  rowsum(dO * O)`` in f32 (plain torch, as the library computes it outside
  any kernel, ``:273-275``), B4 (:func:`flash_attention_bwd_dkv`) and B5
  (:func:`flash_attention_bwd_dq`), ``csrc/flash_attention_bwd.cu`` on a
  CUDA tensor (their plain versions on a CPU one). The three training
  kernels take the same five head dims (ColSmol-500M, ColPali-v1.3 and
  ColQwen2.5-v0.2 training).
- Each kernel wrapper counts its launches (``.launches``): the serving
  forward in ``flash_attention.launches``, the forward that saves lse in
  ``flash_attention_fwd.launches``.
- Declared difference: the library rounds P and dS to the input dtype before
  its products. The f32 kernels keep them in f32; the bf16 kernels (K10's
  forward, B4 and B5 on the tensor cores) feed them in as a bf16 pair hi +
  lo, about 16 significant bits. In bf16, B4 may split each kv head's group of query
  heads over more blocks; its scratch (the range table, then the slices'
  f32 partial sums) is sized by ``vrt_flash_attention_bwd_dkv_scratch``.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from visual_rag_tpu_torch.ops.kernels import _build
from visual_rag_tpu_torch.ops.kernels._checks import on_cpu, ptr, stream_ptr

# the instances of csrc/flash_attention.cu (both forwards) and csrc/flash_attention_bwd.cu
KERNEL_HEAD_DIMS = (64, 72, 80, 128, 256)
TILE = 64  # rows a query tile
MIN_KV_TILE = 32  # keys of the smallest kv tile (Dh 256): the tile-range scratch is sized by it
MAX_TILES = 16384  # csrc/flash_attention.cu MAX_TILES, in query tiles
MAX_BWD_T = 524288  # csrc/flash_common.cuh MAX_BWD_T: the longest sequence B4 and B5 take
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def _check_args(q, k, v, seg) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError("q, k and v must be [B, T, H, Dh]")
    b, t, hq, dh = q.shape
    if k.shape != v.shape or k.shape[:2] != (b, t) or k.shape[3] != dh:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} do not fit q "
                         f"{tuple(q.shape)}")
    if k.shape[2] == 0 or hq % k.shape[2]:
        raise ValueError(f"{hq} query heads are not a multiple of {k.shape[2]} kv heads")
    if seg.shape != (b, t) or seg.dtype != torch.int32:
        raise ValueError(f"seg must be int32 [{b}, {t}], got {seg.dtype} {tuple(seg.shape)}")
    if not (q.device == k.device == v.device == seg.device):
        raise ValueError("q, k, v and seg must be on one device")


def _scale(dh: int, sm_scale: Optional[float]) -> float:
    return float(dh) ** -0.5 if sm_scale is None else float(sm_scale)


def _check_kernel_inputs(named) -> None:
    """What every K10, B4 and B5 launch needs of its [B, T, H, Dh] inputs."""
    q = named[0][1]
    b, t, hq, dh = q.shape
    if q.dtype not in _DTYPE_CODES or any(x.dtype != q.dtype for _, x in named):
        raise ValueError("the flash-attention kernels take f32 or bf16 "
                         + ", ".join(f"{n} ({x.dtype})" for n, x in named) + " of one dtype")
    if dh not in KERNEL_HEAD_DIMS:
        raise ValueError(f"the flash-attention kernel takes head dims {KERNEL_HEAD_DIMS}, "
                         f"got {dh}")
    vec = 16 // q.element_size()
    for name, x in named:
        if x.stride(3) != 1 or any(s % vec for s in x.stride()[:3]) or x.data_ptr() % 16:
            raise ValueError(f"{name} rows must be contiguous and 16-byte aligned "
                             f"(strides {x.stride()})")
    if -(-t // TILE) > MAX_TILES or hq > 65535 or b > 65535:
        raise ValueError(f"the flash-attention kernel does not take B {b}, T {t}, Hq {hq}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, seg: torch.Tensor, *,
                    causal: bool, sm_scale: Optional[float] = None) -> torch.Tensor:
    """Attention output [B, T, Hq, Dh] in q's dtype (module docstring).

    ``sm_scale`` defaults to ``Dh ** -0.5``, the JAX ``mha``'s."""
    _check_args(q, k, v, seg)
    scale = _scale(q.shape[3], sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        return FlashAttentionFn.apply(q, k, v, seg, causal, scale)
    if on_cpu(q):
        return flash_attention_plain(q, k, v, seg, causal=causal, sm_scale=scale)
    return _launch_forward(q, k, v, seg, causal, scale, save_lse=False)[0]


flash_attention.launches = 0


def flash_attention_fwd(q, k, v, seg, *, causal: bool,
                        sm_scale: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse): the forward that keeps its residual for the backward. On
    a CUDA tensor K10 with lse (``Dh`` in ``KERNEL_HEAD_DIMS``, else it raises);
    on a CPU tensor :func:`flash_attention_fwd_plain`."""
    _check_args(q, k, v, seg)
    scale = _scale(q.shape[3], sm_scale)
    if on_cpu(q):
        return flash_attention_fwd_plain(q, k, v, seg, causal=causal, sm_scale=scale)
    return _launch_forward(q, k, v, seg, causal, scale, save_lse=True)


flash_attention_fwd.launches = 0


def _launch_forward(q, k, v, seg, causal, scale, save_lse: bool):
    b, t, hq, dh = q.shape
    _check_kernel_inputs((("q", q), ("k", k), ("v", v)))
    out = torch.empty((b, t, hq, dh), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, hq, t), dtype=torch.float32, device=q.device) if save_lse
           else None)
    if b == 0 or t == 0:
        return out, lse
    seg = seg.contiguous()
    ranges = torch.empty((b, -(-t // MIN_KV_TILE), 2), dtype=torch.int32, device=q.device)
    lib = _build.load_library()
    err = lib.vrt_flash_attention(
        q.device.index, _DTYPE_CODES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(seg), ptr(ranges),
        ptr(out), ptr(lse), b, t, hq, k.shape[2], dh, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(bool(causal)), scale, stream_ptr(q.device))
    _build.check(err, "flash_attention launch")
    (flash_attention_fwd if save_lse else flash_attention).launches += 1
    return out, lse


def _launch_backward(which: str, q, k, v, seg, do, lse, di, causal, scale):
    """B4 (``which`` "dkv") or B5 ("dq") on CUDA tensors."""
    b, t, hq, dh = q.shape
    _check_kernel_inputs((("q", q), ("k", k), ("v", v), ("do", do)))
    if do.shape != q.shape:
        raise ValueError(f"do {tuple(do.shape)} does not fit q {tuple(q.shape)}")
    for name, x in (("lse", lse), ("di", di)):
        if (x.shape != (b, hq, t) or x.dtype != torch.float32 or not x.is_contiguous()
                or x.device != q.device):
            raise ValueError(f"{name} must be a contiguous f32 [{b}, {hq}, {t}] tensor beside q")
    if t > MAX_BWD_T:
        raise ValueError(f"B4 and B5 take T up to {MAX_BWD_T}, got {t}")
    outs = ([torch.empty(k.shape, dtype=q.dtype, device=q.device) for _ in range(2)]
            if which == "dkv" else [torch.empty(q.shape, dtype=q.dtype, device=q.device)])
    if b == 0 or t == 0:
        return outs
    seg = seg.contiguous()
    lib = _build.load_library()
    if which == "dkv":  # the range table, and bf16's partial sums of a split head group
        scratch = torch.empty(lib.vrt_flash_attention_bwd_dkv_scratch(
            q.device.index, _DTYPE_CODES[q.dtype], b, t, hq, k.shape[2], dh),
            dtype=torch.uint8, device=q.device)
    else:
        scratch = torch.empty((b, -(-t // MIN_KV_TILE), 2), dtype=torch.int32, device=q.device)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *do.stride()[:3])
    fn = lib.vrt_flash_attention_bwd_dkv if which == "dkv" else lib.vrt_flash_attention_bwd_dq
    err = fn(q.device.index, _DTYPE_CODES[q.dtype], ptr(q), ptr(k), ptr(v), ptr(do), ptr(seg),
             ptr(scratch), ptr(lse), ptr(di), *(ptr(x) for x in outs), b, t, hq, k.shape[2], dh,
             strides, int(bool(causal)), scale, stream_ptr(q.device))
    _build.check(err, f"flash_attention_bwd_{which} launch")
    (flash_attention_bwd_dkv if which == "dkv" else flash_attention_bwd_dq).launches += 1
    return outs


def flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, *, causal: bool,
                            sm_scale: Optional[float] = None):
    """B4: (dk, dv) [B, T, Hkv, Dh] in q's dtype, summed over each kv head's
    group of query heads. ``do`` is [B, T, Hq, Dh]; ``lse`` and ``di`` f32
    [B, Hq, T]. Launches ``csrc/flash_attention_bwd.cu`` on a CUDA tensor,
    :func:`flash_attention_bwd_dkv_plain` on a CPU one."""
    _check_args(q, k, v, seg)
    scale = _scale(q.shape[3], sm_scale)
    if on_cpu(q):
        return flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di, causal=causal,
                                             sm_scale=scale)
    dk, dv = _launch_backward("dkv", q, k, v, seg, do, lse, di, causal, scale)
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def flash_attention_bwd_dq(q, k, v, seg, do, lse, di, *, causal: bool,
                           sm_scale: Optional[float] = None) -> torch.Tensor:
    """B5: dq [B, T, Hq, Dh] in q's dtype (arguments as
    :func:`flash_attention_bwd_dkv`)."""
    _check_args(q, k, v, seg)
    scale = _scale(q.shape[3], sm_scale)
    if on_cpu(q):
        return flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, causal=causal,
                                            sm_scale=scale)
    (dq,) = _launch_backward("dq", q, k, v, seg, do, lse, di, causal, scale)
    return dq


flash_attention_bwd_dq.launches = 0


def attention_di(out: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """di = rowsum(dO * O) in f32, [B, Hq, T] contiguous (library ``:273``)."""
    return (out.float() * do.float()).sum(dim=-1).transpose(1, 2).contiguous()


class FlashAttentionFn(torch.autograd.Function):
    """K10 with its backward: the forward saves q, k, v, seg, o and lse; the
    backward computes di, then B4 and B5 (module docstring)."""

    @staticmethod
    def forward(ctx, q, k, v, seg, causal: bool, scale: float):
        out, lse = flash_attention_fwd(q, k, v, seg, causal=causal, sm_scale=scale)
        ctx.save_for_backward(q, k, v, seg, out, lse)
        ctx.causal, ctx.scale = causal, scale
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, seg, out, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        di = attention_di(out, do)
        kw = dict(causal=ctx.causal, sm_scale=ctx.scale)
        dk, dv = flash_attention_bwd_dkv(q, k, v, seg, do, lse, di, **kw)
        dq = flash_attention_bwd_dq(q, k, v, seg, do, lse, di, **kw)
        return dq, dk, dv, None, None, None


def allowed_pairs(seg: torch.Tensor, causal: bool) -> torch.Tensor:
    """bool [T, T] for one batch row: key j allowed for query i."""
    ok = seg[:, None] == seg[None, :]
    if causal:
        ok &= torch.ones_like(ok).tril()
    return ok


def flash_attention_fwd_plain(q, k, v, seg, *, causal: bool,
                              sm_scale: Optional[float] = None):
    """Plain PyTorch version of the forward and its residual: (out, lse).
    A dense f32 softmax over the allowed keys of each row, one (batch row,
    head) at a time so that its [T, T] transient stays about 1.2 GB at T =
    17408; ``lse = m + log(l)`` f32 [B, Hq, T], -inf for a row with no
    allowed key."""
    _check_args(q, k, v, seg)
    b, t, hq, dh = q.shape
    group = hq // k.shape[2]
    scale = _scale(dh, sm_scale)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, hq, t), dtype=torch.float32, device=q.device)
    for bi in range(b):
        masked = ~allowed_pairs(seg[bi], causal)
        for h in range(hq):
            s = q[bi, :, h].float() @ k[bi, :, h // group].float().T
            s.mul_(scale).masked_fill_(masked, float("-inf"))
            mx = s.amax(dim=1, keepdim=True)
            mx = torch.where(torch.isfinite(mx), mx, 0.0)
            s.sub_(mx).exp_()
            den = s.sum(dim=1, keepdim=True)
            o = (s @ v[bi, :, h // group].float()) / torch.where(den > 0, den, 1.0)
            out[bi, :, h] = o.to(q.dtype)
            lse[bi, h] = (mx + den.log())[:, 0]
            del s
    return out, lse


def flash_attention_plain(q, k, v, seg, *, causal: bool,
                          sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of :func:`flash_attention` (the output of
    :func:`flash_attention_fwd_plain`)."""
    return flash_attention_fwd_plain(q, k, v, seg, causal=causal, sm_scale=sm_scale)[0]


def _bwd_plain(q, k, v, seg, do, lse, di, causal, sm_scale, want_dq: bool, want_dkv: bool):
    """The function of the library's ``mha_reference_bwd`` (``:1615-1676``)
    with segment ids and grouped kv heads, in f32, one (batch row, kv head)
    at a time: P = exp(s q.k - lse) on allowed pairs and 0 elsewhere (so no
    NaN from a row with no allowed key), dS = P (dO.v - di); dq = s dS k,
    dk = s sum over the group of dS^T q, dv = sum over the group of P^T dO."""
    _check_args(q, k, v, seg)
    b, t, hq, dh = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    scale = _scale(dh, sm_scale)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) if want_dq else None
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device) if want_dkv else None
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device) if want_dkv else None
    for bi in range(b):
        masked = ~allowed_pairs(seg[bi], causal)
        for kh in range(hkv):
            kf, vf = k[bi, :, kh].float(), v[bi, :, kh].float()
            dk_acc = torch.zeros((t, dh), dtype=torch.float32, device=q.device)
            dv_acc = torch.zeros((t, dh), dtype=torch.float32, device=q.device)
            for h in range(kh * group, (kh + 1) * group):
                qf, dof = q[bi, :, h].float(), do[bi, :, h].float()
                p = qf @ kf.T
                p.mul_(scale).sub_(lse[bi, h][:, None]).exp_().masked_fill_(masked, 0.0)
                if want_dkv:
                    dv_acc += p.T @ dof
                ds = (dof @ vf.T).sub_(di[bi, h][:, None]).mul_(p)
                del p
                if want_dkv:
                    dk_acc += ds.T @ qf
                if want_dq:
                    dq[bi, :, h] = ((ds @ kf) * scale).to(q.dtype)
                del ds
            if want_dkv:
                dk[bi, :, kh] = (dk_acc * scale).to(k.dtype)
                dv[bi, :, kh] = dv_acc.to(v.dtype)
    return dq, dk, dv


def flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di, *, causal: bool,
                                  sm_scale: Optional[float] = None):
    """Plain PyTorch version of B4: (dk, dv)."""
    _, dk, dv = _bwd_plain(q, k, v, seg, do, lse, di, causal, sm_scale, False, True)
    return dk, dv


def flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, *, causal: bool,
                                 sm_scale: Optional[float] = None) -> torch.Tensor:
    """Plain PyTorch version of B5: dq."""
    return _bwd_plain(q, k, v, seg, do, lse, di, causal, sm_scale, True, False)[0]
