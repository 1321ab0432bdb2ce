"""Parameters for the port's ColVLM: carried from a flax tree, or drawn at random.

New in the port, beside the JAX package's HF converter
(``visual_rag_tpu/models/convert.py``; loading an HF checkpoint into the port
waits until such files are in the repository).

- :func:`params_from_flax` maps the JAX ColVLM's param tree, as nested dicts
  of numpy arrays (the caller applies ``jax.tree.map(np.asarray, ...)``, so
  this module needs no jax), onto the port's ``state_dict``. A flax ``Dense``
  kernel is ``[in, out]`` and becomes torch's ``[out, in]`` weight; every
  tensor takes the dtype of the port's parameter (bf16 for the Dense layers
  and tables of a bf16 config, as flax's ``dtype`` casts them; f32 for the
  norm scales).
- :func:`init_params` draws random weights with flax's initializers:
  ``lecun_normal`` Dense kernels (a normal truncated at two deviations,
  scaled to variance ``1 / fan_in``), zero biases, ``normal(0.02)`` token and
  position tables, ones for norm scales. The numbers differ from JAX's for
  the same seed; tests carry parameters across instead.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

import numpy as np
import torch

from visual_rag_tpu_torch.models.colvlm import ColVLM, ColVLMConfig

# port name pieces <- flax name pieces
_RENAMES = ((re.compile(r"^vision\.block_(\d+)\."), r"vision.blocks.\1."),
            (re.compile(r"^layer_(\d+)\."), r"layers.\1."),
            (re.compile(r"^embedding_proj\."), "proj."),
            (re.compile(r"\.kernel$"), ".weight"),
            (re.compile(r"^tok_embed\.embedding$"), "tok_embed.weight"))
# flax's lecun_normal: truncated normal whose std is divided by this so that
# the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out = {}
    for key, val in tree.items():
        name = f"{prefix}{key}"
        if isinstance(val, Mapping):
            out.update(_flatten(val, name + "."))
        else:
            out[name] = np.asarray(val)
    return out


def _port_name(flax_name: str) -> str:
    for pat, rep in _RENAMES:
        flax_name = pat.sub(rep, flax_name)
    return flax_name


def params_from_flax(params: Mapping[str, Any], cfg: ColVLMConfig) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) from a flax ColVLM param tree.

    Raises if a tensor of either side has no counterpart or another shape."""
    if "params" in params:
        params = params["params"]
    flat = {_port_name(k): (k, v) for k, v in _flatten(params).items()}
    want = ColVLM(cfg, device="meta").state_dict()
    missing = sorted(set(want) - set(flat))
    extra = sorted(set(flat) - set(want))
    if missing or extra:
        raise ValueError(f"flax params do not fit the port's ColVLM: missing {missing[:5]}, "
                         f"unexpected {[flat[k][0] for k in extra[:5]]}")
    out = {}
    for name, ref in want.items():
        src, arr = flat[name]
        arr = np.array(arr, dtype=np.float32)  # a writable copy
        if src.endswith(".kernel"):
            arr = arr.T
        if tuple(arr.shape) != tuple(ref.shape):
            raise ValueError(f"{src}: shape {arr.shape}, the port's {name} is {tuple(ref.shape)}")
        out[name] = torch.from_numpy(np.ascontiguousarray(arr)).to(ref.dtype)
    return out


def init_params(cfg: ColVLMConfig, seed: int = 0, device="cuda") -> Dict[str, torch.Tensor]:
    """Random weights for the port's ColVLM on ``device``, from ``seed``
    (module docstring)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    out = {}
    for name, ref in ColVLM(cfg, device="meta").state_dict().items():
        t = torch.empty(ref.shape, dtype=torch.float32, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if name in ("tok_embed.weight", "vision.pos_embed"):
            t.normal_(0.0, 0.02, generator=gen)
        elif leaf == "weight":  # Dense kernels, [out, in]
            std = (1.0 / ref.shape[1]) ** 0.5 / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif leaf == "bias":
            t.zero_()
        elif leaf == "scale":
            t.fill_(1.0)
        else:
            raise ValueError(f"no initializer for {name}")
        out[name] = t.to(ref.dtype)
    return out


def build_model(cfg: ColVLMConfig, state_dict: Mapping[str, torch.Tensor], device) -> ColVLM:
    """A ColVLM on ``device`` holding ``state_dict`` (moved there), in eval mode."""
    model = ColVLM(cfg, device="meta")
    model.load_state_dict({k: v.to(device) for k, v in state_dict.items()}, assign=True)
    return model.eval()
