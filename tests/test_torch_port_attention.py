"""K10's plain version and the port's ``mha`` against the JAX package, on the CPU.

- :func:`flash_attention_plain` against the TPU kernel itself: the library's
  Pallas ``flash_attention`` run in interpret mode on the CPU, with segment
  ids (two or three segments, then pads), causal and not, f32 (atol 1e-5,
  every row, pads included) and bf16 (atol 2e-2: the TPU kernel rounds its
  softmax weights to bf16 before the product with v, the plain version
  keeps them in f32; ~2 bf16 ulps at |o| ~ 2), at head dim 64 (ColSmol), at
  ColPali's 72 (vision) and 256 (text) and at ColQwen2.5's 80 (vision) and
  128 (text); ColQwen's window segments, interleaved in the sequence as the
  processor's merge-block order lays them out (runs of 16 patches of one
  window over four block rows), then pads. Grouped kv heads against
  ``jnp.repeat`` followed by the library kernel: Hq 4 on Hkv 2 at Dh 64,
  Gemma's 8 on 1 at Dh 256 and Qwen2.5's 16 on 2 at Dh 128.
- The port's ``mha`` against the JAX ``mha`` on the CPU, whose dense
  fallback runs there: with ``use_flash=True`` (K10's semantics) on the
  valid rows, and with ``use_flash=False`` (the dense fallback's own) on
  every row, pads included, at 1e-5 in f32.
- On a CPU tensor the wrapper runs the plain version and counts no launch.

The backward (B4, B5):

- The plain backward (:func:`flash_attention_bwd_dq_plain`,
  :func:`flash_attention_bwd_dkv_plain`, fed by :func:`flash_attention_fwd_plain`'s
  lse and ``attention_di``) against ``jax.grad`` of the library kernel under
  ``pltpu.force_tpu_interpret_mode()`` (its custom VJP runs the library's B4
  and B5 in interpret mode), with a random dO, segment ids and pads, causal
  and not, at head dims 64, 72, 80 (also over ColQwen's interleaved window
  segments), 128 and 256: dq, dk and dv within 1e-5
  of each tensor's largest magnitude in f32 (every row, pads included); in
  bf16 within 2**-6 of it plus one output ulp an element (the library rounds
  P and dS to bf16 before its products, the port keeps them f32: a few bf16
  ulps of the largest term). Grouped heads (4 on 2, 15 on 5, ColPali's 8 on
  1 at Dh 256 beside its 16 heads of 72, each over one segment of valid
  tokens then pads, and ColQwen's 16 on 2 at Dh 128, causal) against
  ``jnp.repeat`` followed by the library: autodiff sums the repeats.
- The autograd Function on the CPU against autograd through the dense
  attention of ``mha(use_flash=False)`` on valid rows (dO zero on pads, as
  the projection mask makes it), f32 at 1e-5; the forward's lse against
  the dense logsumexp; a row alone in its segment gets zero dq.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import jax
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as tpu_flash

from visual_rag_tpu.models.attention import mha as jax_mha
from visual_rag_tpu_torch.models.attention import mha, segment_ids
from visual_rag_tpu_torch.ops.kernels.flash_attention import (
    attention_di,
    flash_attention,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_fwd,
    flash_attention_fwd_plain,
    flash_attention_plain,
)

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DH = 64


def _inputs(seed, b, t, hq, hkv, n_segments, dh=DH):
    """q [B, T, Hq, Dh], k and v [B, T, Hkv, Dh] N(0, 1); seg [B, T] int32:
    n_segments runs of valid tokens (ids 1..n), then pads (0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, dh)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, dh)).astype(np.float32)
    seg = np.zeros((b, t), np.int32)
    for i in range(b):
        n = t - int(rng.integers(1, t // 4))
        cuts = np.sort(rng.choice(np.arange(1, n), n_segments - 1, replace=False))
        seg[i, :n] = 1 + np.searchsorted(cuts, np.arange(n), side="right")
    return q, k, v, seg


def _tpu_kernel(q, k, v, seg, causal, dtype):
    """The library kernel in interpret mode, in the port's [B, T, H, Dh] layout."""
    to = lambda x: jnp.moveaxis(jnp.asarray(x, dtype), 2, 1)  # noqa: E731
    with pltpu.force_tpu_interpret_mode():
        out = tpu_flash(to(q), to(k), to(v),
                        segment_ids=SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg)),
                        causal=causal, sm_scale=q.shape[-1] ** -0.5)
    return np.asarray(jnp.moveaxis(out, 1, 2).astype(jnp.float32))


def _port(q, k, v, seg, causal, dtype):
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    out = flash_attention_plain(t(q), t(k), t(v), torch.from_numpy(seg), causal=causal)
    assert out.dtype == dtype
    return out.float().numpy()


@pytest.mark.parametrize("t,h,n_segments,causal,dtype,atol", [
    (128, 2, 2, False, torch.float32, 1e-5),
    (256, 2, 3, True, torch.float32, 1e-5),
    (384, 4, 3, False, torch.float32, 1e-5),
    (256, 2, 2, True, torch.bfloat16, 2e-2),
    (128, 4, 3, False, torch.bfloat16, 2e-2),
])
def test_plain_matches_the_tpu_kernel(t, h, n_segments, causal, dtype, atol):
    q, k, v, seg = _inputs(t + h, 2, t, h, h, n_segments)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _tpu_kernel(q, k, v, seg, causal, jdt)
    if dtype == torch.bfloat16:  # both sides read the same bf16 inputs
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    got = _port(q, k, v, seg, causal, dtype)
    np.testing.assert_allclose(got, want, rtol=0, atol=atol)


@pytest.mark.parametrize("dh,t,h,n_segments,causal,dtype,atol", [
    (72, 128, 2, 2, False, torch.float32, 1e-5),
    (72, 256, 2, 3, True, torch.float32, 1e-5),
    (72, 128, 2, 2, False, torch.bfloat16, 2e-2),
    (256, 128, 2, 2, False, torch.float32, 1e-5),
    (256, 256, 2, 3, True, torch.float32, 1e-5),
    (256, 128, 2, 2, True, torch.bfloat16, 2e-2),
])
def test_plain_matches_the_tpu_kernel_at_colpali_head_dims(dh, t, h, n_segments, causal, dtype,
                                                           atol):
    """ColPali's vision tower (Dh 72) and Gemma text model (Dh 256)."""
    q, k, v, seg = _inputs(t + dh, 2, t, h, h, n_segments, dh=dh)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _tpu_kernel(q, k, v, seg, causal, jdt)
    if dtype == torch.bfloat16:
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    np.testing.assert_allclose(_port(q, k, v, seg, causal, dtype), want, rtol=0, atol=atol)


@pytest.mark.parametrize("dh,t,h,n_segments,causal,dtype,atol", [
    (80, 128, 2, 2, False, torch.float32, 1e-5),
    (80, 256, 2, 3, True, torch.float32, 1e-5),
    (80, 128, 2, 2, False, torch.bfloat16, 2e-2),
    (128, 128, 2, 2, False, torch.float32, 1e-5),
    (128, 256, 2, 3, True, torch.float32, 1e-5),
    (128, 128, 2, 2, True, torch.bfloat16, 2e-2),
])
def test_plain_matches_the_tpu_kernel_at_colqwen_head_dims(dh, t, h, n_segments, causal, dtype,
                                                           atol):
    """ColQwen2.5's vision tower (Dh 80) and Qwen2.5 text model (Dh 128)."""
    q, k, v, seg = _inputs(t + dh + 1, 2, t, h, h, n_segments, dh=dh)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _tpu_kernel(q, k, v, seg, causal, jdt)
    if dtype == torch.bfloat16:
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    np.testing.assert_allclose(_port(q, k, v, seg, causal, dtype), want, rtol=0, atol=atol)


def _window_segments(gh, gw, t):
    """ColQwen2.5's vision segments for one page of gh x gw patches in the
    processor's merge-block order (``processors.py:197-222``): window id + 1
    of each 8 x 8 patch window, then pads (0) up to t."""
    hp = np.arange(gh).repeat(gw).reshape(gh, gw)
    wp = np.tile(np.arange(gw), (gh, 1))
    order = lambda a: a.reshape(gh // 2, 2, gw // 2, 2).transpose(0, 2, 1, 3).reshape(-1)  # noqa: E731
    hp, wp = order(hp), order(wp)
    seg = np.zeros(t, np.int32)
    seg[:gh * gw] = (hp // 8) * -(-gw // 8) + wp // 8 + 1
    return seg


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
def test_interleaved_window_segments_match_the_tpu_kernel(dtype, atol):
    """A 20 x 22 patch page (3 x 3 windows, those at the right and bottom
    edges partial) and a 16 x 24 one, then pads to T 512, at Dh 80: one
    window's patches lie in runs of 16 (12 at the right edge) spread over
    four merge-block rows."""
    seg = np.stack([_window_segments(20, 22, 512), _window_segments(16, 24, 512)])
    runs = np.diff(np.flatnonzero(np.diff(seg[0][:440])) + 1)
    assert set(runs.tolist()) == {12, 16} and seg[0].max() == 9 and seg[1].max() == 6
    first = np.flatnonzero(seg[0] == 1)
    assert len(first) == 64 and first[-1] - first[0] > 64  # not one run
    q, k, v, _ = _inputs(31, 2, 512, 2, 2, 2, dh=80)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _tpu_kernel(q, k, v, seg, False, jdt)
    if dtype == torch.bfloat16:
        q, k, v = (np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32)) for x in (q, k, v))
    np.testing.assert_allclose(_port(q, k, v, seg, False, dtype), want, rtol=0, atol=atol)


@pytest.mark.parametrize("causal", [False, True])
def test_qwen_grouped_heads_match_repeat_then_the_tpu_kernel(causal):
    """16 query heads on 2 kv heads at Dh 128, as ColQwen2.5's text model."""
    q, k, v, seg = _inputs(13, 1, 128, 16, 2, 2, dh=128)
    want = _tpu_kernel(q, np.repeat(k, 8, axis=2), np.repeat(v, 8, axis=2), seg, causal,
                       jnp.float32)
    np.testing.assert_allclose(_port(q, k, v, seg, causal, torch.float32), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_gemma_grouped_heads_match_repeat_then_the_tpu_kernel(causal):
    """8 query heads on one kv head at Dh 256, as ColPali's text model."""
    q, k, v, seg = _inputs(9, 1, 128, 8, 1, 2, dh=256)
    want = _tpu_kernel(q, np.repeat(k, 8, axis=2), np.repeat(v, 8, axis=2), seg, causal,
                       jnp.float32)
    np.testing.assert_allclose(_port(q, k, v, seg, causal, torch.float32), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_grouped_kv_heads_match_repeat_then_the_tpu_kernel(causal):
    q, k, v, seg = _inputs(7, 1, 256, 4, 2, 2)
    want = _tpu_kernel(q, np.repeat(k, 2, axis=2), np.repeat(v, 2, axis=2), seg, causal,
                       jnp.float32)
    np.testing.assert_allclose(_port(q, k, v, seg, causal, torch.float32), want,
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("causal,windows", [(True, False), (False, True)])
def test_mha_matches_the_jax_mha(causal, windows):
    """JAX ``mha`` on the CPU runs its dense fallback. Valid rows agree with
    K10's semantics; the dense fallback itself agrees on every row."""
    q, k, v, seg = _inputs(11, 2, 96, 4, 4, 3)
    mask = seg > 0
    segments = (seg - 1) * 5 if windows else None  # window ids, any values
    want = np.asarray(jax_mha(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.asarray(mask), causal=causal, dtype=jnp.float32,
                              segments=None if segments is None else jnp.asarray(segments)))
    tq, tk, tv, tm = (torch.from_numpy(x) for x in (q, k, v, mask))
    ts = None if segments is None else torch.from_numpy(segments)
    got = mha(tq, tk, tv, tm, causal=causal, dtype=torch.float32, segments=ts).numpy()
    np.testing.assert_allclose(got[mask], want[mask], rtol=0, atol=1e-5)
    dense = mha(tq, tk, tv, tm, causal=causal, dtype=torch.float32, segments=ts,
                use_flash=False).numpy()
    np.testing.assert_allclose(dense, want, rtol=0, atol=1e-5)
    # the dense path repeats grouped kv heads itself
    grouped = mha(tq, tk[:, :, :2], tv[:, :, :2], tm, causal=causal, dtype=torch.float32,
                  segments=ts, use_flash=False)
    again = mha(tq, tk[:, :, :2].repeat_interleave(2, 2), tv[:, :, :2].repeat_interleave(2, 2),
                tm, causal=causal, dtype=torch.float32, segments=ts, use_flash=False)
    torch.testing.assert_close(grouped, again, rtol=0, atol=0)


def test_segment_ids_follow_the_jax_mha():
    mask = torch.tensor([[True, True, True, False]])
    assert segment_ids(mask).tolist() == [[1, 1, 1, 0]]
    assert segment_ids(mask, torch.tensor([[0, 0, 4, -1]])).tolist() == [[1, 1, 5, 0]]
    with pytest.raises(NotImplementedError, match="ring"):
        mha(torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8), torch.zeros(1, 4, 1, 8), mask,
            causal=True, dtype=torch.float32, ring_axis="sp")


def test_cpu_tensors_run_the_plain_version():
    q, k, v, seg = _inputs(5, 1, 70, 2, 1, 2)
    before = flash_attention.launches
    args = [torch.from_numpy(x) for x in (q, k, v, seg)]
    torch.testing.assert_close(flash_attention(*args, causal=True),
                               flash_attention_plain(*args, causal=True), rtol=0, atol=0)
    assert flash_attention.launches == before
    with pytest.raises(ValueError, match="multiple"):
        flash_attention(args[0][:, :, :1].repeat(1, 1, 3, 1), args[1].repeat(1, 1, 2, 1),
                        args[2].repeat(1, 1, 2, 1), args[3], causal=False)


# -- the backward: B4 and B5 -----------------------------------------------------


def _tpu_grads(q, k, v, seg, do, causal, dtype):
    """dq, dk, dv of sum(o * dO) through the library kernel in interpret mode
    (its custom VJP: B4 and B5), in the port's layout; kv heads repeated
    first where there are fewer (autodiff sums the repeats)."""
    rep = q.shape[2] // k.shape[2]
    to = lambda x: jnp.moveaxis(jnp.asarray(x, dtype), 2, 1)  # noqa: E731
    segs = SegmentIds(q=jnp.asarray(seg), kv=jnp.asarray(seg))
    dout = to(do)

    def f(q, k, v):
        o = tpu_flash(q, jnp.repeat(k, rep, axis=1), jnp.repeat(v, rep, axis=1),
                      segment_ids=segs, causal=causal, sm_scale=q.shape[-1] ** -0.5)
        return jnp.sum(o.astype(jnp.float32) * dout.astype(jnp.float32))

    with pltpu.force_tpu_interpret_mode():
        grads = jax.grad(f, argnums=(0, 1, 2))(to(q), to(k), to(v))
    return [np.asarray(jnp.moveaxis(g, 1, 2).astype(jnp.float32)) for g in grads]


def _port_grads(q, k, v, seg, do, causal, dtype):
    t = lambda x: torch.from_numpy(x).to(dtype)  # noqa: E731
    q, k, v, do, seg = t(q), t(k), t(v), t(do), torch.from_numpy(seg)
    out, lse = flash_attention_fwd_plain(q, k, v, seg, causal=causal)
    di = attention_di(out, do)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, seg, do, lse, di, causal=causal)
    dq = flash_attention_bwd_dq_plain(q, k, v, seg, do, lse, di, causal=causal)
    assert dq.dtype == dk.dtype == dv.dtype == dtype
    return [x.float().numpy() for x in (dq, dk, dv)]


def _bf16(x):
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _assert_grads_close(got, want, dtype):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        scale = float(np.abs(w).max())
        if dtype == torch.float32:
            tol = 1e-5 * scale
        else:  # a few bf16 ulps of the largest term, plus one ulp an element
            tol = 2.0 ** -6 * scale + 2.0 ** -8 * np.abs(w)
        assert (np.abs(g - w) <= tol).all(), (name, float(np.abs(g - w).max()), scale)


@pytest.mark.parametrize("dh,t,n_segments,causal,dtype", [
    (64, 256, 3, True, torch.float32),
    (64, 128, 2, False, torch.float32),
    (72, 128, 2, True, torch.float32),
    (72, 256, 3, False, torch.float32),
    (80, 256, 3, True, torch.float32),
    (80, 128, 2, False, torch.float32),
    (128, 128, 2, True, torch.float32),
    (128, 256, 3, False, torch.float32),
    (256, 256, 3, True, torch.float32),
    (256, 128, 2, False, torch.float32),
    (64, 256, 3, True, torch.bfloat16),
    (256, 128, 2, False, torch.bfloat16),
])
def test_plain_backward_matches_the_tpu_kernels(dh, t, n_segments, causal, dtype):
    """B4 and B5's plain versions against the library's backward kernels."""
    q, k, v, seg = _inputs(t + dh + 2, 2, t, 2, 2, n_segments, dh=dh)
    do = np.random.default_rng(dh + t).standard_normal(q.shape).astype(np.float32)
    if dtype == torch.bfloat16:  # both sides read the same bf16 inputs
        q, k, v, do = (_bf16(x) for x in (q, k, v, do))
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = _tpu_grads(q, k, v, seg, do, causal, jdt)
    _assert_grads_close(_port_grads(q, k, v, seg, do, causal, dtype), want, dtype)


@pytest.mark.parametrize("hq,hkv,causal,dh,n_segments", [
    pytest.param(4, 2, True, DH, 2, id="4-2-True"),
    pytest.param(15, 5, False, DH, 2, id="15-5-False"),
    # ColPali: Gemma's 8 heads of 256 on one kv head and SigLIP's 16 heads of 72, both
    # bidirectional over one segment of valid tokens, then pads
    pytest.param(8, 1, False, 256, 1, id="8-1-False-256-prefix"),
    pytest.param(16, 16, False, 72, 1, id="16-16-False-72-prefix"),
    # ColQwen2.5: Qwen2.5's 16 heads of 128 on 2 kv heads, causal
    pytest.param(16, 2, True, 128, 2, id="16-2-True-128")])
def test_plain_backward_sums_grouped_heads_as_the_tpu_kernels(hq, hkv, causal, dh, n_segments):
    """Grouped kv heads (ColSmol's text model: 15 on 5; ColPali's Gemma: 8
    on 1; ColQwen2.5's Qwen2.5: 16 on 2): dk and dv sum the group's query
    heads, as autodiff of ``jnp.repeat`` does."""
    q, k, v, seg = _inputs(hq + 40, 1, 128, hq, hkv, n_segments, dh=dh)
    do = np.random.default_rng(hq).standard_normal(q.shape).astype(np.float32)
    want = _tpu_grads(q, k, v, seg, do, causal, jnp.float32)
    _assert_grads_close(_port_grads(q, k, v, seg, do, causal, torch.float32), want,
                        torch.float32)


def test_plain_backward_on_interleaved_window_segments_matches_the_tpu_kernels():
    """ColQwen2.5's vision windows at Dh 80 (the pages of
    ``test_interleaved_window_segments_match_the_tpu_kernel``: one window's
    patches in runs of 16 over four merge-block rows, then pads to T 512),
    bidirectional: dq, dk and dv within 1e-5 of each tensor's largest (f32)."""
    seg = np.stack([_window_segments(20, 22, 512), _window_segments(16, 24, 512)])
    q, k, v, _ = _inputs(37, 2, 512, 2, 2, 2, dh=80)
    do = np.random.default_rng(80).standard_normal(q.shape).astype(np.float32)
    want = _tpu_grads(q, k, v, seg, do, False, jnp.float32)
    _assert_grads_close(_port_grads(q, k, v, seg, do, False, torch.float32), want,
                        torch.float32)


@pytest.mark.parametrize("causal,hq,hkv", [(True, 6, 2), (False, 3, 3)])
def test_autograd_function_matches_dense_attention_on_valid_rows(causal, hq, hkv):
    """The Function (plain forward with lse, then B4 and B5's plain versions)
    against autograd through the dense attention; dO is zero on pad rows,
    as the model's projection mask makes it, so the two agree on every
    gradient although pad queries attend differently."""
    q, k, v, seg = _inputs(17 + hq, 2, 90, hq, hkv, 3)
    mask = seg > 0
    do = np.random.default_rng(3).standard_normal(q.shape).astype(np.float32)
    do[~mask] = 0.0
    grads = []
    for flash in (True, False):
        tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        out = mha(tq, tk, tv, torch.from_numpy(mask), causal=causal, dtype=torch.float32,
                  use_flash=flash)
        (out * torch.from_numpy(do)).sum().backward()
        grads.append([x.grad.numpy() for x in (tq, tk, tv)])
    for got, want in zip(*grads):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_forward_lse_is_the_logsumexp_of_the_allowed_logits():
    """lse = logsumexp of the allowed scaled logits (f32 [B, Hq, T]); a row
    whose only allowed key is itself gets that logit and finite gradients."""
    q, k, v, seg = _inputs(23, 1, 64, 2, 1, 2)
    seg[0, 40] = 7  # row 40: a segment of its own
    tq, tk, tv, ts = (torch.from_numpy(x) for x in (q, k, v, seg))
    out, lse = flash_attention_fwd_plain(tq, tk, tv, ts, causal=True)
    logits = torch.einsum("bqhd,bkhd->bhqk", tq, tk.repeat_interleave(2, dim=2)) / 8.0
    ok = (ts[:, None, :, None] == ts[:, None, None, :]) & torch.ones(64, 64).tril().bool()
    want = torch.logsumexp(logits.masked_fill(~ok, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=0, atol=1e-5)
    torch.testing.assert_close(out[0, 40], tv[0, 40].expand(2, -1), rtol=0, atol=0)
    do = torch.randn(out.shape, generator=torch.Generator().manual_seed(0))
    di = attention_di(out, do)
    dq = flash_attention_bwd_dq(tq, tk, tv, ts, do, lse, di, causal=True)
    dk, dv = flash_attention_bwd_dkv(tq, tk, tv, ts, do, lse, di, causal=True)
    assert all(torch.isfinite(x).all() for x in (dq, dk, dv))
    # a softmax over one key has no gradient in q: dS = P (dO.v - dO.o) with o = v,
    # two f32 sums of the same products in other orders
    assert dq[0, 40].abs().max() < 1e-5


def test_function_counts_no_launch_on_the_cpu():
    q, k, v, seg = _inputs(29, 1, 70, 2, 1, 2)
    counters = (flash_attention, flash_attention_fwd, flash_attention_bwd_dkv,
                flash_attention_bwd_dq)
    before = [f.launches for f in counters]
    tq = torch.from_numpy(q).requires_grad_()
    flash_attention(tq, torch.from_numpy(k), torch.from_numpy(v), torch.from_numpy(seg),
                    causal=True).sum().backward()
    assert tq.grad is not None and torch.isfinite(tq.grad).all()
    assert [f.launches for f in counters] == before
