"""Late-interaction contrastive training for the port's ColVLM on one device.

Counterpart of ``visual_rag_tpu/models/train.py:30-235``. The objective is
the JAX package's (the ColPali-family recipe): embed a batch of queries and
their positive pages, score every query against every page with MaxSim
(:func:`~visual_rag_tpu_torch.ops.maxsim.maxsim_matrix_padded`), and take
in-batch-negative cross-entropy over the [B, B] score matrix (diagonal =
positives). Every attention layer runs K10's forward with its residuals and
B4/B5 in the backward (``ops/kernels/flash_attention.py``); the dense
products are cuBLAS, as XLA's are in JAX.

- :func:`make_optimizer` is optax's ``chain(clip_by_global_norm(1.0),
  adamw(sched, b1=0.9, b2=0.999, eps=1e-8, weight_decay))`` written out,
  without optax: the clip is ``g / ||g|| * 1.0`` only where ``||g|| >= 1``;
  step n (0-based) uses ``sched(n)``, so with warmup the first step moves
  nothing; the decay is ``lr * wd * p`` on the parameters before the step,
  on every parameter.
- :class:`Trainer` keeps the master weights in f32, as flax keeps them,
  and computes in ``cfg.dtype``. There is no mesh: the port
  trains on one device (the ``dp1`` mesh of the JAX CLI).
- Like the JAX step, which donates its params and optimizer state, a step
  updates them in place: the :class:`TrainState` passed in is consumed.
- Checkpoints are ``torch.save`` files in the JAX package's
  ``step_{step:08d}`` directories; orbax's format is a declared difference.
"""

from __future__ import annotations

import dataclasses
import math
import os
import shutil
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from visual_rag_tpu_torch.device import resolve_device
from visual_rag_tpu_torch.models.colvlm import ColVLM, ColVLMConfig
from visual_rag_tpu_torch.models.convert import init_params
from visual_rag_tpu_torch.ops.maxsim import maxsim_matrix_padded
from visual_rag_tpu_torch.tracing import span

Params = Dict[str, torch.Tensor]


@dataclasses.dataclass
class AdamWState:
    """optax's ``scale_by_adam`` state: first and second moments, f32, and
    the number of steps taken (the schedule's count too)."""

    mu: Params
    nu: Params
    count: int = 0


@dataclasses.dataclass
class TrainState:
    params: Params
    opt_state: AdamWState
    step: int = 0


def colbert_infonce_loss(q_emb, q_mask, p_emb, p_mask, temperature: float = 0.02):
    """(loss, metrics): cross-entropy of the [B, B] MaxSim matrix over the
    temperature against the diagonal; ``in_batch_acc`` (argmax on the
    diagonal) and ``pos_score`` (mean diagonal score) beside it."""
    scores = maxsim_matrix_padded(q_emb, q_mask, p_emb, p_mask)  # [B, B]
    labels = torch.arange(scores.shape[0], device=scores.device)
    loss = F.cross_entropy(scores / temperature, labels)
    acc = (scores.argmax(dim=1) == labels).float().mean()
    metrics = {"loss": loss.detach(), "in_batch_acc": acc,
               "pos_score": scores.diagonal().mean().detach()}
    return loss, metrics


# -- schedules (optax's, as functions of the 0-based step) ----------------------


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    def sched(count: int) -> float:
        count = min(count, decay_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * count / decay_steps))
        return init_value * ((1.0 - alpha) * cosine + alpha)
    return sched


def warmup_cosine_decay_schedule(init_value: float, peak_value: float, warmup_steps: int,
                                 decay_steps: int, end_value: float = 0.0):
    """Linear from ``init_value`` to ``peak_value`` over ``warmup_steps``,
    then cosine to ``end_value`` at ``decay_steps`` (optax's join)."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    cosine = cosine_decay_schedule(peak_value, decay_steps - warmup_steps, alpha)

    def sched(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - count / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        return cosine(count - warmup_steps)
    return sched


class AdamW:
    """optax ``chain(clip_by_global_norm(max_norm), adamw(schedule, b1, b2,
    eps, weight_decay))`` over a dict of tensors, updating in place (module
    docstring). Moments are f32 whatever the parameters' dtype."""

    def __init__(self, schedule: Callable[[int], float], b1: float = 0.9, b2: float = 0.999,
                 eps: float = 1e-8, weight_decay: float = 0.01, max_norm: float = 1.0):
        self.schedule, self.b1, self.b2, self.eps = schedule, b1, b2, eps
        self.weight_decay, self.max_norm = weight_decay, max_norm

    def init(self, params: Params) -> AdamWState:
        zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                 for k, p in params.items()}
        return AdamWState(mu=zeros, nu={k: torch.zeros_like(z) for k, z in zeros.items()},
                          count=0)

    @torch.no_grad()
    def update(self, grads: Params, state: AdamWState, params: Params) -> AdamWState:
        """One step: ``params`` and ``state``'s moments change in place."""
        b1, b2 = self.b1, self.b2
        norm = torch.sqrt(sum(g.float().square().sum() for g in grads.values()))
        clip = bool(norm >= self.max_norm)
        n = state.count
        lr = float(np.float32(self.schedule(n)))
        # 1 - b ** count in f32, as optax's bias correction
        bc1 = float(np.float32(1.0) - np.float32(b1) ** np.float32(n + 1))
        bc2 = float(np.float32(1.0) - np.float32(b2) ** np.float32(n + 1))
        for name, p in params.items():
            g = grads[name].float()
            if clip:
                g = g / norm * self.max_norm
            mu = state.mu[name].mul_(b1).add_((1 - b1) * g)
            nu = state.nu[name].mul_(b2).add_((1 - b2) * (g * g))
            upd = (mu / bc1) / (torch.sqrt(nu / bc2) + self.eps)
            upd.add_(self.weight_decay * p.float())
            p.add_((upd * -lr).to(p.dtype))
        state.count = n + 1
        return state


def make_optimizer(lr: float = 5e-5, weight_decay: float = 0.01, warmup: int = 100,
                   total_steps: int = 10_000) -> AdamW:
    """The JAX package's optimizer (``train.py:53-62``): cosine decay over
    ``total_steps`` (after a linear warmup from 0 when ``warmup`` > 0),
    global-norm clip 1.0, AdamW."""
    if warmup <= 0:
        sched = cosine_decay_schedule(lr, total_steps)
    else:
        sched = warmup_cosine_decay_schedule(0.0, lr, warmup, max(total_steps, warmup + 1))
    return AdamW(sched, b1=0.9, b2=0.999, weight_decay=weight_decay)


# master weights, as flax keeps them: bf16 would lose AdamW's updates (about lr, 1e-4)
# below its ulp
MASTER_DTYPE = torch.float32
BATCH_KEYS = ("query_ids", "query_mask", "page_ids", "page_mask", "patches", "patch_mask",
              "window_ids")


class Trainer:
    """Master weights, optimizer and train step of the port's ColVLM on one
    device (``device`` as :func:`~visual_rag_tpu_torch.device.resolve_device`
    takes it; the CPU only when asked for). A config with MoE (or another
    field the port's ColVLM refuses) raises ``NotImplementedError`` here."""

    def __init__(self, cfg: ColVLMConfig, lr: float = 5e-5, temperature: float = 0.02,
                 warmup: int = 100, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = ColVLM(cfg, device="meta", param_dtype=MASTER_DTYPE)
        self.optimizer = make_optimizer(lr=lr, warmup=warmup)
        self.temperature = float(temperature)

    def init_state(self, seed: int = 0, params: Optional[Params] = None) -> TrainState:
        """Random parameters from ``seed`` (``init_params``) drawn on the
        device, or ``params`` (a state dict, e.g. carried from flax) moved
        there in f32; zero moments, step 0."""
        if params is None:
            params = init_params(self.cfg, seed, self.device, param_dtype=MASTER_DTYPE)
        params = self._as_params(params)
        return TrainState(params=params, opt_state=self.optimizer.init(params), step=0)

    def _as_params(self, params: Params) -> Params:
        """Leaf tensors on the device that require grad, in the model's
        parameter dtypes, as ``nn.Parameter`` so the model can hold them."""
        want = dict(self.model.named_parameters())
        if set(params) != set(want):
            raise ValueError(f"parameters do not fit the model: missing "
                             f"{sorted(set(want) - set(params))[:5]}, unexpected "
                             f"{sorted(set(params) - set(want))[:5]}")
        return {k: torch.nn.Parameter(v.detach().to(self.device, want[k].dtype))
                for k, v in params.items()}

    def _to_device(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        out = {}
        for key in BATCH_KEYS:
            if batch.get(key) is not None:
                x = batch[key]
                x = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.asarray(x))
                out[key] = x.to(self.device, non_blocking=True)
        return out

    def _loss_fn(self, params: Params, batch: Dict[str, torch.Tensor]):
        """(loss, metrics) of ``params`` on ``batch`` (``train.py:93-120``)."""
        self.model.load_state_dict(params, assign=True)  # the model holds these tensors
        q_emb = self.model(batch["query_ids"], batch["query_mask"])
        p_emb = self.model(batch["page_ids"], batch["page_mask"], batch["patches"],
                           batch["patch_mask"], batch.get("window_ids"))
        return colbert_infonce_loss(q_emb, batch["query_mask"], p_emb, batch["page_mask"],
                                    temperature=self.temperature)

    def value_and_grad(self, params: Params, batch) -> Tuple[Tuple[torch.Tensor, Dict], Params]:
        """((loss, metrics), grads) as ``jax.value_and_grad(_loss_fn,
        has_aux=True)``; grads are f32 in the parameters' dtypes."""
        batch = self._to_device(batch)
        with torch.enable_grad():
            loss, metrics = self._loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(params.values()), allow_unused=True,
                                        materialize_grads=True)
        return (loss.detach(), metrics), dict(zip(params, grads))

    def make_train_step(self):
        """``train_step(params, opt_state, batch) -> (params, opt_state,
        metrics)``; params and opt_state are updated in place."""

        def train_step(params: Params, opt_state: AdamWState, batch):
            with span("train.step"):
                (_, metrics), grads = self.value_and_grad(params, batch)
                with span("train.optimizer"):
                    opt_state = self.optimizer.update(grads, opt_state, params)
            return params, opt_state, metrics

        return train_step

    def train_step_once(self, state: TrainState, batch) -> Tuple[TrainState, Dict]:
        params, opt_state, metrics = self.make_train_step()(state.params, state.opt_state, batch)
        return TrainState(params, opt_state, state.step + 1), metrics


@torch.no_grad()
def ema_update(ema: Params, params: Params, decay: float) -> Params:
    """Exponential moving average of the parameters: an f32 lerp of each
    leaf, cast back to its dtype (``train.py:160-174``). Returns new tensors."""
    d = np.float32(decay)
    d, one_minus = float(d), float(np.float32(1.0) - d)  # f32 values, as JAX's weak scalars
    return {k: (e.float() * d + params[k].detach().float() * one_minus).to(e.dtype)
            for k, e in ema.items()}


def _checkpoint_dir(directory, step: int) -> Path:
    return Path(directory).resolve() / f"step_{step:08d}"


def save_train_state(state: TrainState, directory, step: Optional[int] = None) -> str:
    """``torch.save`` of params, optimizer state and step into
    ``directory/step_{step:08d}/state.pt`` (written beside it, then renamed
    into place). Returns the directory."""
    step = state.step if step is None else int(step)
    path = _checkpoint_dir(directory, step)
    tmp = path.with_name(path.name + f".tmp{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    cpu = lambda d: {k: v.detach().cpu() for k, v in d.items()}  # noqa: E731
    torch.save({"params": cpu(state.params),
                "opt_state": {"mu": cpu(state.opt_state.mu), "nu": cpu(state.opt_state.nu),
                              "count": state.opt_state.count},
                "step": step}, tmp / "state.pt")
    shutil.rmtree(path, ignore_errors=True)
    os.replace(tmp, path)
    return str(path)


def restore_train_state(directory, step: Optional[int] = None,
                        template: Optional[TrainState] = None, device="cuda") -> TrainState:
    """The latest (or the given) step under ``directory``. Tensors go to the
    device of ``template``'s parameters if given (as the JAX template gives
    shardings), else to ``device`` (as :class:`Trainer` takes it: the CPU only
    when asked for); parameters come back as ``nn.Parameter``s."""
    root = Path(directory).resolve()
    if step is None:
        steps = sorted(int(p.name.split("_")[1]) for p in root.glob("step_*")
                       if p.name.split("_")[1].isdigit())
        if not steps:
            raise FileNotFoundError(f"no checkpoints under {root}")
        step = steps[-1]
    if template is not None:
        device = next(iter(template.params.values())).device
    device = resolve_device(device)
    data = torch.load(_checkpoint_dir(root, step) / "state.pt", map_location=device,
                      weights_only=True)
    opt = data["opt_state"]
    return TrainState(params={k: torch.nn.Parameter(v) for k, v in data["params"].items()},
                      opt_state=AdamWState(mu=opt["mu"], nu=opt["nu"], count=int(opt["count"])),
                      step=int(data["step"]))


def synthetic_batch(cfg: ColVLMConfig, batch: int, query_len: int, n_patches: int,
                    seed: int = 0) -> Dict[str, torch.Tensor]:
    """Deterministic synthetic (query, page) batch (``train.py:214-235``):
    the same arrays as the JAX package's for a seed, as CPU tensors."""
    rng = np.random.default_rng(seed)
    m2 = cfg.spatial_merge * cfg.spatial_merge
    n_img_tokens = n_patches // m2
    page_len = n_img_tokens + 4
    page_ids = np.full((batch, page_len), cfg.image_token_id, dtype=np.int32)
    page_ids[:, n_img_tokens:] = rng.integers(4, min(cfg.text.vocab, 1000), (batch, 4))
    query_ids = rng.integers(4, min(cfg.text.vocab, 1000), (batch, query_len)).astype(np.int32)
    patches = rng.standard_normal((batch, n_patches, cfg.vision.patch_pixels)).astype(np.float32)
    return {
        "query_ids": torch.from_numpy(query_ids),
        "query_mask": torch.ones((batch, query_len), dtype=torch.bool),
        "page_ids": torch.from_numpy(page_ids),
        "page_mask": torch.ones((batch, page_len), dtype=torch.bool),
        "patches": torch.from_numpy(patches),
        "patch_mask": torch.ones((batch, n_patches), dtype=torch.bool),
    }
