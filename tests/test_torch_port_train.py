"""The port's training path against the JAX package's, on the CPU.

The same numpy inputs go through ``visual_rag_tpu/models/train.py`` (its
``Trainer`` on a one-device CPU mesh, whose attention runs the dense
fallback there) and ``visual_rag_tpu_torch/models/train.py`` (K10's plain
version with lse and B4/B5's plain versions behind the autograd Function),
with the flax parameters carried across unrounded (``param_dtype`` f32):

- ``synthetic_batch`` equal to JAX's for a seed, array for array;
- ``ops/maxsim.py`` (l2_normalize, the single and batch scores, the padded
  scores and matrix with masked tokens and a token-less doc, pad_ragged)
  against ``visual_rag_tpu/ops/maxsim.py`` at 1e-6 (absolute and relative: the
  unnormalized scores reach ~30);
- ``colbert_infonce_loss`` and its metrics against JAX's at 1e-6;
- the optimizer against optax's chain (clip 1.0, AdamW, cosine or
  warmup-cosine) over 3 steps, with warmup 0 and 2, gradients large enough
  to clip and small enough not to: parameters and moments at 1e-7;
- ``ema_update`` against JAX's within one f32 ulp (both an f32 lerp; XLA
  may fuse it into an FMA);
- loss and every gradient leaf against ``jax.value_and_grad(Trainer._loss_fn)``
  for ``ColVLMConfig.tiny()``, a ColSmol-shaped config (pixel shuffle 2,
  attention biases, per-tile window ids, a padded page) and a ColPali-shaped
  one (SigLIP 144 wide on 2 heads of 72 with attention biases; Gemma 512
  wide on 2 query heads of 256 and one kv head, bidirectional, offset
  RMSNorm, GeGLU, the embedding scale; 256-patch pages, one padded): f32
  loss at 1e-5 and each leaf within 1e-4 of its largest JAX magnitude plus 1e-5 (the
  key biases' exact gradient is 0, so both sides give f32 noise there);
  bf16 compute (f32 master weights on both sides) loosely: the loss within
  2e-2 relative (1% measured) and each leaf's gradient at cosine >= 0.95
  with JAX's (0.974 at worst measured): the frameworks round bf16 at other
  places, and the loss's temperature 0.02 multiplies score differences by
  50, so single elements differ by up to half the leaf's largest;
- parameters after one and two full steps (lr 1e-4) against JAX's: within
  1e-6 where the JAX gradient (of each step so far) exceeds 1e-4 of its
  leaf's largest (1e-3 in the ColPali-shaped case, ``CLEAR_SHARE``) and,
  after the global-norm clip, 1000 Adam eps; within
  2 lr (1 + wd) everywhere (Adam's first steps turn noise-level gradients
  into +-lr);
- a second step on the same batch lowers the loss; ``remat=True`` gives the
  same loss and gradients (1e-6) for the ColSmol- and ColPali-shaped
  configs; save, restore and continue equals the
  live run bit for bit; the CLI trains ``--tiny --synthetic`` and
  ``--data`` on a temporary ``pairs.jsonl`` of seeded ``.npy`` pages, and
  refuses what the port does not run.
"""

import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from visual_rag_tpu.models import colvlm as J
from visual_rag_tpu.models import train as JT
from visual_rag_tpu.ops import maxsim as JM
from visual_rag_tpu.parallel import make_mesh
from visual_rag_tpu_torch.models import colvlm as P
from visual_rag_tpu_torch.models import train as PT
from visual_rag_tpu_torch.models.convert import params_from_flax
from visual_rag_tpu_torch.ops import maxsim as PM

torch.set_num_threads(1)  # tier-1 runs several test workers at once

ROOT = Path(__file__).resolve().parents[1]
LR, WD = 1e-4, 0.01  # lr as chip_smoke.py's training phase
TILE = 256  # patches a tile at pixel shuffle 2
CP_PATCHES = 256  # a 16 x 16 patch page of the ColPali-shaped config
CQ_PATCHES = 256  # the largest page of the ColQwen-shaped config: 16 x 16 patches


def _tiny(cls, dtype="float32"):
    return dataclasses.replace(cls.tiny(), dtype=dtype)


def _colsmol_shaped(cls, dtype="float32"):
    """``tests/test_torch_port_colvlm.py``'s ``_cfg``: the tiny widths with
    ColSmol's pixel shuffle (2 here), attention and projection biases."""
    tiny = cls.tiny()
    return dataclasses.replace(
        tiny, dtype=dtype, proj_bias=True, connector_bias=False,
        vision=dataclasses.replace(tiny.vision, pixel_shuffle=2, max_patches=2048,
                                   attn_bias=True))


def _colsmol_batch(cfg, seed=0):
    """Three (query, page) pairs: pages of 2 tiles (the third padded from 1),
    their per-tile window ids (-1 on pads), 128 or 64 image slots and a
    4-token prompt, then pads; queries of 9-12 tokens, then pads."""
    rng = np.random.default_rng(seed)
    b, n = 3, 2 * TILE
    patches = rng.random((b, n, cfg.vision.patch_pixels), dtype=np.float32)
    pmask = np.ones((b, n), bool)
    pmask[2, TILE:] = False
    patches[2, TILE:] = 0.0
    wids = np.repeat(np.arange(2, dtype=np.int32), TILE)[None].repeat(b, 0)
    wids[2, TILE:] = -1
    ids = rng.integers(4, cfg.text.vocab, (b, 136)).astype(np.int32)
    ids[:2, :128] = cfg.image_token_id
    ids[2, :64] = cfg.image_token_id
    amask = np.ones((b, 136), bool)
    amask[2, 68:] = False
    q_ids = rng.integers(4, cfg.text.vocab, (b, 12)).astype(np.int32)
    q_mask = np.ones((b, 12), bool)
    q_mask[1, 9:] = False
    return {"query_ids": q_ids, "query_mask": q_mask, "page_ids": ids, "page_mask": amask,
            "patches": patches, "patch_mask": pmask, "window_ids": wids}


def _colpali_shaped(cls, dtype="float32"):
    """``tests/test_torch_port_colvlm.py``'s ``_colpali_cfg``: ColPali-v1.3's
    shape at tiny widths, keeping both of its head dims (72 and 256)."""
    tiny = cls.tiny()
    return dataclasses.replace(
        tiny, dtype=dtype, proj_bias=True, connector_bias=True, hf_layout="paligemma",
        vision=dataclasses.replace(tiny.vision, hidden=144, heads=2, max_patches=CP_PATCHES,
                                   attn_bias=True),
        text=dataclasses.replace(tiny.text, hidden=512, heads=2, kv_heads=1, mlp_hidden=1024,
                                 rope_theta=10000.0, mlp_act="gelu_tanh", rms_offset=True,
                                 embed_scale=True, causal=False, max_seq=512))


def _colpali_batch(cfg, seed=0):
    """Three (query, page) pairs: pages of 256 patches (the third padded
    from 200), as many image slots and a 4-token prompt, then pads (no
    window ids: SigLIP attends over the whole page); queries of 9-12 tokens,
    then pads."""
    rng = np.random.default_rng(seed)
    b, n = 3, CP_PATCHES
    patches = rng.random((b, n, cfg.vision.patch_pixels), dtype=np.float32)
    pmask = np.ones((b, n), bool)
    pmask[2, 200:] = False
    patches[2, 200:] = 0.0
    ids = rng.integers(4, cfg.text.vocab - 20, (b, n + 8)).astype(np.int32)
    ids[:2, :n] = cfg.image_token_id
    ids[2, :200] = cfg.image_token_id
    amask = np.ones((b, n + 8), bool)
    amask[2, 204:] = False
    q_ids = rng.integers(4, cfg.text.vocab - 20, (b, 12)).astype(np.int32)
    q_mask = np.ones((b, 12), bool)
    q_mask[1, 9:] = False
    return {"query_ids": q_ids, "query_mask": q_mask, "page_ids": ids, "page_mask": amask,
            "patches": patches, "patch_mask": pmask}


def _colqwen_shaped(cls, dtype="float32"):
    """``tests/test_torch_port_colvlm.py``'s ``_colqwen_cfg``: ColQwen2.5-v0.2's
    shape at tiny widths, keeping both of its head dims (vision 160 wide on 2
    heads of 80 with attention biases, window segments and the middle of its 3
    layers full; Qwen2.5 text 256 wide on 2 query heads of 128 and one kv head,
    causal, M-RoPE); 256-patch pages."""
    real = cls.colqwen25_v02()
    return dataclasses.replace(
        real, dtype=dtype, image_token_id=500,
        vision=dataclasses.replace(real.vision, hidden=160, layers=3, heads=2, mlp_ratio=2.0,
                                   patch_pixels=48, max_patches=CQ_PATCHES,
                                   full_attn_layers=(1,)),
        text=dataclasses.replace(real.text, hidden=256, layers=2, heads=2, kv_heads=1,
                                 mlp_hidden=512, vocab=512, max_seq=512))


def _colqwen_batch(cfg, seed=0):
    """Three (query, page) pairs through the port's ``colqwen2.5`` processor:
    pages of 10 x 24, 18 x 14 and 16 x 16 patches (the first two padded to
    256) with their window ids (2 x 3, 3 x 2 and 2 x 2 windows of 8 x 8
    patches, interleaved in the merge-block order) and patch positions, as
    many image slots / 4 and the prompt, then pads; queries of 3-10 tokens,
    then pads."""
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    rng = np.random.default_rng(seed)
    proc = ImageProcessor(backend="colqwen2.5", image_token_id=cfg.image_token_id,
                          patch_pixels=cfg.vision.patch_pixels, vocab=cfg.text.vocab,
                          max_visual_tokens=cfg.vision.max_patches // 4)
    pages = proc.process_images([rng.random(hw + (3,), dtype=np.float32)
                                 for hw in ((200, 520), (300, 200), (120, 120))])
    assert pages.patch_mask.sum(1).tolist() == [240, 252, CQ_PATCHES]
    q_ids, q_mask = proc.process_queries(["what is the revenue of the third quarter",
                                          "a chart of annual growth in the report", "cost"])
    return {"query_ids": q_ids, "query_mask": q_mask, "page_ids": pages.input_ids,
            "page_mask": pages.attn_mask, "patches": pages.patches,
            "patch_mask": pages.patch_mask, "window_ids": pages.window_ids,
            "patch_positions": pages.patch_positions}


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _leaves(params, cfg):
    """A flax tree (params or grads) as the port's f32 state dict."""
    return params_from_flax(_np(params), cfg, param_dtype=torch.float32)


class Case:
    """One config and batch run through JAX: its params, loss, grads and the
    params after one and two steps (lr 1e-4, no warmup)."""

    def __init__(self, make_cfg, batch, dtype="float32"):
        self.cfg_j, self.cfg_p = make_cfg(J.ColVLMConfig, dtype), make_cfg(P.ColVLMConfig, dtype)
        self.batch = batch(self.cfg_j) if callable(batch) else batch
        mesh = make_mesh((1,), ("dp",), devices=jax.devices()[:1])
        trainer = JT.Trainer(self.cfg_j, mesh, lr=LR, warmup=0)
        jbatch = {k: jnp.asarray(v) for k, v in self.batch.items()}
        state = trainer.init_state(jax.random.PRNGKey(1), jbatch)
        self.params = _np(state.params)
        (loss, self.metrics), grads = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(
            state.params, jbatch)
        self.loss, self.grads = float(loss), _leaves(grads, self.cfg_p)
        step = trainer.make_train_step()
        params, opt, _ = step(jax.tree.map(jnp.copy, state.params), state.opt_state, jbatch)
        self.params1 = _leaves(params, self.cfg_p)
        (_, _), grads1 = jax.jit(jax.value_and_grad(trainer._loss_fn, has_aux=True))(
            params, jbatch)
        self.grads1 = _leaves(grads1, self.cfg_p)
        params, opt, _ = step(params, opt, jbatch)
        self.params2 = _leaves(params, self.cfg_p)

    def trainer(self, **kw):
        return PT.Trainer(self.cfg_p, lr=LR, warmup=0, device="cpu", **kw)

    def state(self, trainer):
        return trainer.init_state(params=params_from_flax(self.params, self.cfg_p,
                                                          param_dtype=torch.float32))


@pytest.fixture(scope="module")
def tiny():
    return Case(_tiny, lambda c: {k: np.asarray(v) for k, v in JT.synthetic_batch(
        c, batch=4, query_len=12, n_patches=64, seed=3).items()})


@pytest.fixture(scope="module")
def colsmol():
    return Case(_colsmol_shaped, _colsmol_batch)


@pytest.fixture(scope="module")
def colpali():
    return Case(_colpali_shaped, _colpali_batch)


@pytest.fixture(scope="module")
def colqwen():
    return Case(_colqwen_shaped, _colqwen_batch)


# -- pieces -----------------------------------------------------------------------


@pytest.mark.parametrize("make_cfg,n_patches", [(_tiny, 64), (_colsmol_shaped, 2 * TILE)])
def test_synthetic_batch_equals_jax(make_cfg, n_patches):
    want = JT.synthetic_batch(make_cfg(J.ColVLMConfig), batch=3, query_len=7,
                              n_patches=n_patches, seed=5)
    got = PT.synthetic_batch(make_cfg(P.ColVLMConfig), batch=3, query_len=7,
                             n_patches=n_patches, seed=5)
    assert set(got) == set(want)
    for key, arr in want.items():
        assert got[key].numpy().dtype == np.asarray(arr).dtype, key
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(arr), err_msg=key)


def test_maxsim_functions_match_jax():
    rng = np.random.default_rng(0)
    q = rng.standard_normal((3, 5, 16)).astype(np.float32)
    qm = np.ones((3, 5), bool)
    qm[1, 3:] = False
    docs = rng.standard_normal((4, 7, 16)).astype(np.float32)
    dm = np.ones((4, 7), bool)
    dm[0, 4:] = False
    dm[2] = False  # a doc with no token scores 0
    close = lambda a, b: np.testing.assert_allclose(  # noqa: E731
        np.asarray(a), np.asarray(b), rtol=1e-6, atol=1e-6)
    close(PM.l2_normalize(q), JM.l2_normalize(q))
    close(PM.compute_maxsim_score(q[0], docs[0]), JM.compute_maxsim_score(q[0], docs[0]))
    close(PM.compute_maxsim_score(q[0], docs[1], normalize=False),
          JM.compute_maxsim_score(q[0], docs[1], normalize=False))
    close(PM.compute_maxsim_batch(q[1], [docs[0][:3], docs[3]]),
          JM.compute_maxsim_batch(q[1], [docs[0][:3], docs[3]]))
    close(PM.maxsim_scores_padded(q[0], docs, dm, qm[1]),
          JM.maxsim_scores_padded(q[0], docs, dm, qm[1]))
    close(PM.maxsim_scores_padded(q[0], docs, dm), JM.maxsim_scores_padded(q[0], docs, dm))
    got = PM.maxsim_matrix_padded(q, qm, docs, dm)
    close(got, JM.maxsim_matrix_padded(q, qm, docs, dm))
    assert (got[:, 2] == 0).all()
    ragged = [docs[0][:3], docs[1], docs[3][:1]]
    for (gv, gm), (wv, wm) in [(PM.pad_ragged(ragged), JM.pad_ragged(ragged)),
                               (PM.pad_ragged(ragged, max_len=5), JM.pad_ragged(ragged, 5))]:
        np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
        np.testing.assert_array_equal(gm.numpy(), np.asarray(wm))


def test_infonce_loss_matches_jax():
    rng = np.random.default_rng(1)
    q = np.asarray(JM.l2_normalize(rng.standard_normal((4, 6, 16)).astype(np.float32)))
    p = np.asarray(JM.l2_normalize(rng.standard_normal((4, 9, 16)).astype(np.float32)))
    qm, pm = np.ones((4, 6), bool), np.ones((4, 9), bool)
    qm[2, 4:], pm[1, 5:] = False, False
    loss, metrics = JT.colbert_infonce_loss(*(jnp.asarray(x) for x in (q, qm, p, pm)),
                                            temperature=0.05)
    got, got_m = PT.colbert_infonce_loss(*(torch.from_numpy(x) for x in (q, qm, p, pm)),
                                         temperature=0.05)
    np.testing.assert_allclose(float(got), float(loss), rtol=1e-6)
    for key in ("in_batch_acc", "pos_score"):
        np.testing.assert_allclose(float(got_m[key]), float(metrics[key]), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("warmup", [0, 2])
def test_optimizer_equals_optax_chain(warmup):
    """3 steps: the first's gradients have a global norm above 1 (clipped),
    the later ones below it; weight decay on every leaf."""
    rng = np.random.default_rng(warmup)
    shapes = {"a": (7, 5), "b": (11,), "c": (3, 4, 2)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (rng.standard_normal(s) * scale).astype(np.float32) for k, s in shapes.items()}
             for scale in (2.0, 0.05, 0.01)]
    opt = JT.make_optimizer(lr=LR, warmup=warmup)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    js = opt.init(jp)
    pt_opt = PT.make_optimizer(lr=LR, warmup=warmup)
    pp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    ps = pt_opt.init(pp)
    for step, g in enumerate(grads):
        updates, js = opt.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, updates)
        ps = pt_opt.update({k: torch.from_numpy(v) for k, v in g.items()}, ps, pp)
        for k in shapes:
            np.testing.assert_allclose(pp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-7,
                                       err_msg=f"{k} after step {step}")
        if warmup and step == 0:  # sched(0) = 0: the first step moves nothing
            for k in shapes:
                np.testing.assert_array_equal(pp[k].numpy(), params[k])
    adam = js[1][0]
    assert ps.count == int(adam.count) == 3
    for k in shapes:
        np.testing.assert_allclose(ps.mu[k].numpy(), np.asarray(adam.mu[k]), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(ps.nu[k].numpy(), np.asarray(adam.nu[k]), rtol=1e-6, atol=1e-12)


def test_schedules_match_optax():
    for got, want in ((PT.cosine_decay_schedule(2e-4, 50), optax.cosine_decay_schedule(2e-4, 50)),
                      (PT.warmup_cosine_decay_schedule(0.0, 2e-4, 10, 60),
                       optax.warmup_cosine_decay_schedule(0.0, 2e-4, 10, 60))):
        for n in (0, 1, 5, 10, 11, 37, 60, 70):
            np.testing.assert_allclose(got(n), float(want(n)), rtol=1e-6, atol=1e-12)


def test_ema_update_matches_jax():
    rng = np.random.default_rng(2)
    ema = {"w": rng.standard_normal((6, 3)).astype(np.float32),
           "b": rng.standard_normal(4).astype(np.float32)}
    new = {k: rng.standard_normal(v.shape).astype(np.float32) for k, v in ema.items()}
    want = JT.ema_update({k: jnp.asarray(v) for k, v in ema.items()},
                         {k: jnp.asarray(v) for k, v in new.items()}, 0.999)
    got = PT.ema_update({k: torch.from_numpy(v) for k, v in ema.items()},
                        {k: torch.from_numpy(v) for k, v in new.items()}, 0.999)
    for k in ema:  # one f32 ulp: XLA may fuse the lerp into an FMA
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=2.0 ** -23, atol=0)
    half = PT.ema_update({"x": torch.ones(3, dtype=torch.bfloat16)},
                         {"x": torch.zeros(3, dtype=torch.bfloat16)}, 0.5)
    assert half["x"].dtype == torch.bfloat16 and (half["x"] == 0.5).all()


# -- the train step against JAX's -------------------------------------------------------


# f32 noise: the k biases' exact gradient is 0 (a shift of every logit of a row
# leaves its softmax as it is), so both sides give rounding noise there, ~1e-6
GRAD_FLOOR = 1e-5


def _assert_grads_close(got, want, rtol_of_max):
    for k, w in want.items():
        scale = float(w.abs().max())
        err = float((got[k] - w).abs().max())
        assert err <= rtol_of_max * scale + GRAD_FLOOR, (k, err, scale)


def _assert_grads_aligned(got, want, min_cos):
    """bf16: each leaf's gradient points where JAX's does."""
    for k, w in want.items():
        if w.abs().max() > GRAD_FLOOR:
            cos = float(torch.nn.functional.cosine_similarity(got[k].flatten(), w.flatten(),
                                                              dim=0))
            assert cos >= min_cos, (k, cos)


@pytest.mark.parametrize("case", ["tiny", "colsmol", "colpali", "colqwen"])
def test_loss_and_grads_match_jax(case, request):
    c = request.getfixturevalue(case)
    trainer = c.trainer()
    (loss, metrics), grads = trainer.value_and_grad(c.state(trainer).params, c.batch)
    np.testing.assert_allclose(float(loss), c.loss, rtol=1e-5)
    np.testing.assert_allclose(float(metrics["pos_score"]), float(c.metrics["pos_score"]),
                               rtol=1e-5)
    assert set(grads) == set(c.grads)
    _assert_grads_close(grads, c.grads, 1e-4)


def test_loss_and_grads_match_jax_in_bf16():
    c = Case(_tiny, lambda cfg: {k: np.asarray(v) for k, v in JT.synthetic_batch(
        cfg, batch=4, query_len=12, n_patches=64, seed=3).items()}, dtype="bfloat16")
    trainer = c.trainer()
    state = c.state(trainer)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    (loss, _), grads = trainer.value_and_grad(state.params, c.batch)
    np.testing.assert_allclose(float(loss), c.loss, rtol=2e-2)
    _assert_grads_aligned(grads, c.grads, 0.95)


def _clear(grads, share=1e-4):
    """Elements whose gradient stands clear of noise: above ``share`` of its
    leaf's largest, and, after optax's global-norm clip, above 1000 Adam eps
    (nearer eps, g / (|g| + eps) turns a gradient's last digits into a
    visible change of the update)."""
    norm = max(1.0, float(torch.sqrt(sum(g.double().square().sum() for g in grads.values()))))
    return {k: (g.abs() > share * g.abs().max()) & (g.abs() / norm > 1000 * 1e-8)
            for k, g in grads.items()}


# the least share of the nonzero gradient elements that the 1e-6 check covers (``_clear`` in
# both steps). The ColPali-shaped model's global gradient norm is ~516 (the others' a few),
# so after the clip more of its elements lie within 1000 eps: 0.856 of them are clear
COVERED = {"tiny": 0.9, "colsmol": 0.9, "colpali": 0.85, "colqwen": 0.9}
# ``_clear``'s share of the leaf's largest gradient. The ColPali-shaped case takes 1e-3: a
# ``tok_embed`` element at 3.3e-4 of its leaf's largest step-2 gradient differs from JAX's by
# 3% of itself (1e-5 of the largest, inside the gradient check's 1e-4), which the second Adam
# step carries into 1.3e-6 of the parameter; at 1e-3 the worst is 5.6e-7
CLEAR_SHARE = {"tiny": 1e-4, "colsmol": 1e-4, "colpali": 1e-3, "colqwen": 1e-4}


def _assert_params_after_steps(got, want, clear):
    """1e-6 where ``clear``; 2 lr (1 + wd) everywhere."""
    for k, w in want.items():
        diff = (got[k].detach() - w).abs()
        assert float(diff.max()) <= 2 * LR * (1 + WD), (k, float(diff.max()))
        if clear[k].any():
            assert float(diff[clear[k]].max()) <= 1e-6, (k, float(diff[clear[k]].max()))


@pytest.mark.parametrize("case", ["tiny", "colsmol", "colpali", "colqwen"])
def test_params_after_one_and_two_steps_match_jax(case, request):
    c = request.getfixturevalue(case)
    trainer = c.trainer()
    state = c.state(trainer)
    state, m0 = trainer.train_step_once(state, c.batch)
    clear0, clear1 = _clear(c.grads, CLEAR_SHARE[case]), _clear(c.grads1, CLEAR_SHARE[case])
    nonzero = sum(int((g != 0).sum()) for g in c.grads.values())
    assert sum(int((clear0[k] & clear1[k]).sum()) for k in clear0) >= COVERED[case] * nonzero
    _assert_params_after_steps(state.params, c.params1, clear0)
    state, m1 = trainer.train_step_once(state, c.batch)
    assert state.step == 2 and state.opt_state.count == 2
    _assert_params_after_steps(state.params, c.params2,
                               {k: clear0[k] & clear1[k] for k in clear0})
    assert float(m1["loss"]) < float(m0["loss"])  # the second step on the batch lowers it


@pytest.mark.parametrize("case", ["colsmol", "colpali", "colqwen"])
def test_remat_gives_the_same_loss_and_grads(case, request):
    c = request.getfixturevalue(case)
    plain, remat = c.trainer(), PT.Trainer(dataclasses.replace(c.cfg_p, remat=True), lr=LR,
                                           warmup=0, device="cpu")
    (l0, _), g0 = plain.value_and_grad(c.state(plain).params, c.batch)
    (l1, _), g1 = remat.value_and_grad(c.state(remat).params, c.batch)
    np.testing.assert_allclose(float(l1), float(l0), rtol=1e-6)
    _assert_grads_close(g1, g0, 1e-6)


def test_trainer_ignores_patch_positions_as_the_jax_trainer_does(colqwen):
    """The JAX ``Trainer._loss_fn`` never passes ``patch_positions``, so a
    ColQwen trained there gets neither the 2-D vision rotary nor image M-RoPE
    positions (a fault of the reference, ROADMAP C). The port's trainer keeps
    that agreement: the batch with the processor's positions gives the loss and
    gradients of the batch without them, bit for bit, on both sides; the model
    itself, given them, embeds the pages otherwise."""
    c = colqwen
    assert "patch_positions" not in PT.BATCH_KEYS
    without = {k: v for k, v in c.batch.items() if k != "patch_positions"}
    trainer = c.trainer()
    params = c.state(trainer).params
    (l0, _), g0 = trainer.value_and_grad(params, c.batch)
    (l1, _), g1 = trainer.value_and_grad(params, without)
    assert float(l0) == float(l1) and all(torch.equal(g0[k], g1[k]) for k in g0)
    mesh = make_mesh((1,), ("dp",), devices=jax.devices()[:1])
    loss_fn = jax.jit(JT.Trainer(c.cfg_j, mesh, lr=LR, warmup=0)._loss_fn)
    jl = [float(loss_fn(c.params, {k: jnp.asarray(v) for k, v in b.items()})[0])
          for b in (c.batch, without)]
    assert jl[0] == jl[1]
    np.testing.assert_allclose(float(l0), jl[0], rtol=1e-5)
    pages = [torch.from_numpy(c.batch[k]) for k in ("page_ids", "page_mask", "patches",
                                                     "patch_mask", "window_ids")]
    with torch.no_grad():
        plain = trainer.model(*pages)
        placed = trainer.model(*pages, torch.from_numpy(c.batch["patch_positions"]))
    assert float((plain - placed).abs().max()) > 1e-3


def test_save_restore_and_continue(tiny, tmp_path):
    trainer = tiny.trainer()
    state, _ = trainer.train_step_once(tiny.state(trainer), tiny.batch)
    path = PT.save_train_state(state, tmp_path)
    assert Path(path).name == "step_00000001"
    restored = PT.restore_train_state(tmp_path, template=state)
    assert restored.step == 1 and restored.opt_state.count == 1
    live, _ = trainer.train_step_once(state, tiny.batch)
    again, _ = trainer.train_step_once(restored, tiny.batch)
    for k in live.params:
        assert torch.equal(live.params[k], again.params[k]), k
        assert torch.equal(live.opt_state.nu[k], again.opt_state.nu[k]), k
    with pytest.raises(FileNotFoundError):
        PT.restore_train_state(tmp_path / "none")


def test_restore_runs_on_the_card_unless_asked(tiny, tmp_path, monkeypatch):
    """Without a template the state goes to ``device``, which defaults to
    the card as the Trainer's does: with no CUDA device that raises
    ``resolve_device``'s error, and ``device="cpu"`` restores on the CPU."""
    trainer = tiny.trainer()
    state = tiny.state(trainer)
    PT.save_train_state(state, tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PT.restore_train_state(tmp_path)
    restored = PT.restore_train_state(tmp_path, device="cpu")
    assert restored.step == 0
    for k, v in state.params.items():
        assert restored.params[k].device.type == "cpu" and torch.equal(restored.params[k], v), k


def test_moe_is_refused():
    cfg = dataclasses.replace(P.ColVLMConfig.tiny(), text=dataclasses.replace(
        P.ColVLMConfig.tiny().text, moe_experts=4))
    with pytest.raises(NotImplementedError, match="moe_experts"):
        PT.Trainer(cfg, device="cpu")


# -- the CLI ----------------------------------------------------------------------------------


def _cli(*args, cwd):
    return subprocess.run([sys.executable, "-m", "visual_rag_tpu_torch.cli.train_colvlm", *args],
                          capture_output=True, text=True, cwd=cwd, timeout=300,
                          env={"PYTHONPATH": str(ROOT), "PATH": "/usr/bin:/bin",
                               "OMP_NUM_THREADS": "1"})


def test_cli_trains_tiny_synthetic(tmp_path):
    out = _cli("--tiny", "--synthetic", "--device", "cpu", "--steps", "2", "--log-every", "1",
               "--batch-size", "2", "--checkpoint-dir", str(tmp_path / "ck"), "--ema-decay",
               "0.9", cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "step     0" in out.stdout and "step     1" in out.stdout
    assert (tmp_path / "ck" / "step_00000002" / "state.pt").exists()
    assert (tmp_path / "ck" / "ema" / "step_00000002" / "state.pt").exists()
    resumed = _cli("--tiny", "--synthetic", "--device", "cpu", "--steps", "3", "--batch-size",
                   "2", "--checkpoint-dir", str(tmp_path / "ck"), "--resume", cwd=tmp_path)
    assert resumed.returncode == 0, resumed.stderr
    assert "resumed from step 2" in resumed.stdout and "step     2" in resumed.stdout


def test_cli_trains_on_a_pairs_file(tmp_path):
    rng = np.random.default_rng(0)
    (tmp_path / "pages").mkdir()
    lines = []
    for i in range(4):
        np.save(tmp_path / "pages" / f"p{i}.npy", rng.random((96, 128, 3), dtype=np.float32))
        lines.append(json.dumps({"query": f"what is on page {i}?", "image": f"pages/p{i}.npy"}))
    (tmp_path / "pairs.jsonl").write_text("\n".join(lines) + "\n")
    out = _cli("--tiny", "--data", str(tmp_path), "--device", "cpu", "--steps", "2",
               "--batch-size", "2", "--log-every", "1", "--checkpoint-dir",
               str(tmp_path / "ck"), cwd=tmp_path)
    assert out.returncode == 0, out.stderr
    assert "4 training pairs" in out.stdout and "step     1" in out.stdout


@pytest.mark.parametrize("args,needle", [
    (("--mesh", "dp2"), "--mesh"), (("--scan-layers",), "--scan-layers"),
    (("--ring-attention",), "--ring-attention"), (("--checkpoint", "x"), "--checkpoint"),
    ((), "--device")])
def test_cli_refuses_what_the_port_does_not_run(args, needle, tmp_path):
    device = () if needle == "--device" else ("--device", "cpu")
    out = _cli("--tiny", "--synthetic", *device, *args, cwd=tmp_path)
    assert out.returncode != 0 and needle in out.stderr
