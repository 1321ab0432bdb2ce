"""K10's plain version and the port's ``mha`` against the JAX package, on the CPU.

- :func:`flash_attention_plain` against the TPU kernel itself: the library's
  Pallas ``flash_attention`` run in interpret mode on the CPU, with segment
  ids (two or three segments, then pads), causal and not, f32 (atol 1e-5,
  every row, pads included) and bf16 (atol 2e-2: the TPU kernel rounds its
  softmax weights to bf16 before the product with v, the plain version
  keeps them in f32; ~2 bf16 ulps at |o| ~ 2). Grouped kv heads (Hq 4, Hkv
  2) against ``jnp.repeat`` followed by the library kernel.
- The port's ``mha`` against the JAX ``mha`` on the CPU, whose dense
  fallback runs there: with ``use_flash=True`` (K10's semantics) on the
  valid rows, and with ``use_flash=False`` (the dense fallback's own) on
  every row, pads included, at 1e-5 in f32.
- On a CPU tensor the wrapper runs the plain version and counts no launch.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from jax.experimental.pallas.ops.tpu.flash_attention import SegmentIds
from jax.experimental.pallas.ops.tpu.flash_attention import flash_attention as tpu_flash

from visual_rag_tpu.models.attention import mha as jax_mha
from visual_rag_tpu_torch.models.attention import mha, segment_ids
from visual_rag_tpu_torch.ops.kernels.flash_attention import (
    flash_attention,
    flash_attention_plain,
)

torch.set_num_threads(1)  # tier-1 runs several test workers at once

DH = 64


def _inputs(seed, b, t, hq, hkv, n_segments):
    """q [B, T, Hq, 64], k and v [B, T, Hkv, 64] N(0, 1); seg [B, T] int32:
    n_segments runs of valid tokens (ids 1..n), then pads (0)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, t, hq, DH)).astype(np.float32)
    k = rng.standard_normal((b, t, hkv, DH)).astype(np.float32)
    v = rng.standard_normal((b, t, hkv, DH)).astype(np.float32)
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
                        causal=causal, sm_scale=DH ** -0.5)
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
