"""Parameters for the port's ColVLM: from an HF state dict, carried from a
flax tree, or drawn at random.

- :func:`params_from_hf` is the counterpart of the JAX package's
  ``convert_state_dict`` (``visual_rag_tpu/models/convert.py:45-288``) for
  the ``idefics3`` (ColSmol), ``paligemma`` (ColPali) and ``qwen2.5``
  (ColQwen2.5) layouts: its mapping (the SigLIP rules ``:61-105``,
  PaliGemma's nesting included, the Qwen2.5-VL vision and merger rules
  ``:108-142`` and the text rules ``:145-213``) is copied here, since the
  JAX module imports flax, and maps each HF tensor straight onto the port's
  parameter name. An HF ``Linear`` is ``[out, in]``, torch's own layout, so
  nothing is transposed; a conv patch embed ``[H, C, k, k]`` becomes the
  ``[H, k*k*C]`` weight of the patch Dense (the processor flattens a patch
  row, column, channel), and Qwen2.5-VL's Conv3d ``[H, C, 2, k, k]`` is
  summed over its two frames first (the image is doubled over them); a
  fused ``attn.qkv`` weight ``[3H, H]`` and bias ``[3H]`` split into q, k
  and v, and the HF key is consumed once all three are mapped. Reading
  safetensors from disk waits until a checkpoint is in the repository.
- :func:`params_from_flax` maps the JAX ColVLM's param tree, as nested dicts
  of numpy arrays (the caller applies ``jax.tree.map(np.asarray, ...)``, so
  this module needs no jax), onto the port's ``state_dict``. A flax ``Dense``
  kernel is ``[in, out]`` and becomes torch's ``[out, in]`` weight; every
  tensor takes the dtype of the port's parameter: by default bf16 for the
  Dense layers and tables of a bf16 config (as flax's ``dtype`` casts them
  at use) and f32 for the norm scales; with ``param_dtype=torch.float32``
  every tensor stays f32, unrounded (the master weights of training).
- :func:`init_params` draws random weights with flax's initializers:
  ``lecun_normal`` Dense kernels (a normal truncated at two deviations,
  scaled to variance ``1 / fan_in``), zero biases, ``normal(0.02)`` token and
  position tables, ones for norm scales, zeros for the scales of Gemma's
  offset RMSNorms (``colvlm.py:241``), on the device it is asked for, in the
  dtypes of ``ColVLM(cfg, param_dtype=...)``. The numbers differ from JAX's
  for the same seed; tests carry parameters across instead.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Mapping, Tuple

import numpy as np
import torch

from visual_rag_tpu_torch.models.colvlm import ColVLM, ColVLMConfig, RMSNorm

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


def params_from_flax(params: Mapping[str, Any], cfg: ColVLMConfig,
                     param_dtype=None) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` (CPU tensors) from a flax ColVLM param tree,
    in the dtypes of ``ColVLM(cfg, param_dtype=param_dtype)``.

    Raises if a tensor of either side has no counterpart or another shape."""
    if "params" in params:
        params = params["params"]
    flat = {_port_name(k): (k, v) for k, v in _flatten(params).items()}
    want = ColVLM(cfg, device="meta", param_dtype=param_dtype).state_dict()
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


def init_params(cfg: ColVLMConfig, seed: int = 0, device="cuda",
                param_dtype=None) -> Dict[str, torch.Tensor]:
    """Random weights for the port's ColVLM on ``device``, from ``seed``
    (module docstring)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    meta = ColVLM(cfg, device="meta", param_dtype=param_dtype)
    offset = {f"{name}.scale" for name, m in meta.named_modules()
              if isinstance(m, RMSNorm) and m.offset}
    out = {}
    for name, ref in meta.state_dict().items():
        t = torch.empty(ref.shape, dtype=torch.float32, device=device)
        leaf = name.rsplit(".", 1)[-1]
        if name in ("tok_embed.weight", "vision.pos_embed"):
            t.normal_(0.0, 0.02, generator=gen)
        elif leaf == "weight":  # Dense kernels, [out, in] (stacked experts: [E, out, in])
            std = (1.0 / ref.shape[-1]) ** 0.5 / _TRUNC_STD
            torch.nn.init.trunc_normal_(t, 0.0, std, -2.0 * std, 2.0 * std, generator=gen)
        elif leaf == "bias" or name in offset:
            t.zero_()
        elif leaf == "scale":
            t.fill_(1.0)
        else:
            raise ValueError(f"no initializer for {name}")
        out[name] = t.to(ref.dtype)
        del t
    return out


def build_model(cfg: ColVLMConfig, state_dict: Mapping[str, torch.Tensor], device) -> ColVLM:
    """A ColVLM on ``device`` holding ``state_dict`` (moved there; each
    parameter keeps the tensor's dtype, so f32 master weights stay f32), in
    eval mode."""
    model = ColVLM(cfg, device="meta")
    model.load_state_dict({k: v.to(device) for k, v in state_dict.items()}, assign=True)
    return model.eval()


# -- HF state dicts (visual_rag_tpu/models/convert.py:40-288) -------------------

KEY_PREFIXES = ("model.", "vlm.model.", "model.model.")  # backbone nestings seen in the wild
HF_LAYOUTS = ("idefics3", "paligemma", "qwen2.5")


def _strip_prefix(key: str) -> str:
    for p in KEY_PREFIXES:
        if key.startswith(p):
            return key[len(p):]
    return key


def _siglip_vision_rules(cfg: ColVLMConfig, prefixes: Tuple[str, ...]):
    """SigLIP tower rules (Idefics3/ColSmol and PaliGemma/ColPali exports):
    ``[(hf_key_candidates, port_name, transform)]``."""
    def cand(suffix: str) -> Tuple[str, ...]:
        return tuple(p + suffix for p in prefixes)

    rules: List[Tuple[Tuple[str, ...], str, str]] = [
        (cand("embeddings.patch_embedding.weight"), "vision.patch_embed.weight", "patch_conv"),
        (cand("embeddings.patch_embedding.bias"), "vision.patch_embed.bias", "raw"),
        (cand("embeddings.position_embedding.weight"), "vision.pos_embed", "raw"),
        (cand("post_layernorm.weight"), "vision.post_ln.scale", "raw"),
        (cand("post_layernorm.bias"), "vision.post_ln.bias", "raw"),
    ]
    for i in range(cfg.vision.layers):
        blk, lyr = f"vision.blocks.{i}.", f"encoder.layers.{i}."
        rules += [
            (cand(f"{lyr}self_attn.q_proj.weight"), blk + "attn.q.weight", "linear"),
            (cand(f"{lyr}self_attn.k_proj.weight"), blk + "attn.k.weight", "linear"),
            (cand(f"{lyr}self_attn.v_proj.weight"), blk + "attn.v.weight", "linear"),
            (cand(f"{lyr}self_attn.out_proj.weight"), blk + "attn.o.weight", "linear"),
            (cand(f"{lyr}layer_norm1.weight"), blk + "ln1.scale", "raw"),
            (cand(f"{lyr}layer_norm1.bias"), blk + "ln1.bias", "raw"),
            (cand(f"{lyr}layer_norm2.weight"), blk + "ln2.scale", "raw"),
            (cand(f"{lyr}layer_norm2.bias"), blk + "ln2.bias", "raw"),
            (cand(f"{lyr}mlp.fc1.weight"), blk + "fc1.weight", "linear"),
            (cand(f"{lyr}mlp.fc1.bias"), blk + "fc1.bias", "raw"),
            (cand(f"{lyr}mlp.fc2.weight"), blk + "fc2.weight", "linear"),
            (cand(f"{lyr}mlp.fc2.bias"), blk + "fc2.bias", "raw"),
        ]
        if cfg.vision.attn_bias:  # SigLIP attention biases (real checkpoints)
            rules += [
                (cand(f"{lyr}self_attn.{hf}_proj.bias"), blk + f"attn.{port}.bias", "raw")
                for hf, port in (("q", "q"), ("k", "k"), ("v", "v"), ("out", "o"))]
    return rules


def _qwen_vision_rules(cfg: ColVLMConfig):
    """Qwen2.5-VL tower and merger rules (``convert.py:108-142``): the fused
    ``attn.qkv``, RMSNorm ``norm1``/``norm2``, the biased SwiGLU MLP, the
    merger's ``ln_q``, ``mlp.0`` and ``mlp.2``, the Conv3d patch embed."""
    rules: List[Tuple[Tuple[str, ...], str, str]] = [
        (("visual.patch_embed.proj.weight",), "vision.patch_embed.weight", "patch_conv3d"),
        (("visual.merger.ln_q.weight",), "merger.ln_q.scale", "raw"),
        (("visual.merger.mlp.0.weight",), "merger.fc1.weight", "linear"),
        (("visual.merger.mlp.0.bias",), "merger.fc1.bias", "raw"),
        (("visual.merger.mlp.2.weight",), "merger.fc2.weight", "linear"),
        (("visual.merger.mlp.2.bias",), "merger.fc2.bias", "raw"),
    ]
    for i in range(cfg.vision.layers):
        blk, lyr = f"vision.blocks.{i}.", f"visual.blocks.{i}."
        for j, x in enumerate("qkv"):
            rules += [((f"{lyr}attn.qkv.weight",), blk + f"attn.{x}.weight", f"qkv_{j}"),
                      ((f"{lyr}attn.qkv.bias",), blk + f"attn.{x}.bias", f"qkv_{j}")]
        rules += [
            ((f"{lyr}attn.proj.weight",), blk + "attn.o.weight", "linear"),
            ((f"{lyr}attn.proj.bias",), blk + "attn.o.bias", "raw"),
            ((f"{lyr}norm1.weight",), blk + "ln1.scale", "raw"),
            ((f"{lyr}norm2.weight",), blk + "ln2.scale", "raw"),
        ]
        rules += [((f"{lyr}mlp.{x}_proj.{leaf}",), blk + f"mlp.{x}.{leaf}",
                   "linear" if leaf == "weight" else "raw")
                  for x in ("gate", "up", "down") for leaf in ("weight", "bias")]
    return rules


def param_mapping(cfg: ColVLMConfig) -> List[Tuple[Tuple[str, ...], str, str]]:
    """``[(hf_key_candidates, port_name, transform)]`` for ``cfg``
    (``convert.py:145-213``). transform: ``linear`` and ``raw`` (as they
    are: HF's ``[out, in]`` is torch's), ``embed`` (the ``[vocab, hidden]``
    table), ``patch_conv`` (``[H, C, k, k]`` -> ``[H, k*k*C]``),
    ``patch_conv3d`` (``[H, C, t, k, k]``, summed over t first) and
    ``qkv_0``/``qkv_1``/``qkv_2`` (the q, k or v third of a fused qkv
    weight or bias)."""
    if cfg.hf_layout not in HF_LAYOUTS:
        raise NotImplementedError(
            f"the port maps the HF layouts {HF_LAYOUTS}, not {cfg.hf_layout!r}")
    text_pre = {"idefics3": ("text_model.",),
                "paligemma": ("language_model.", "text_model."),
                "qwen2.5": ("language_model.", "text_model.")}[cfg.hf_layout]

    def tc(suffix: str) -> Tuple[str, ...]:
        return tuple(p + suffix for p in text_pre)

    rules: List[Tuple[Tuple[str, ...], str, str]] = [
        (tc("embed_tokens.weight"), "tok_embed.weight", "embed"),
        (tc("norm.weight"), "final_norm.scale", "raw"),
        # the projection head's name differs between colpali and smolvlm exports
        (("custom_text_proj.weight", "embedding_proj_layer.weight"), "proj.weight", "linear"),
    ]
    if cfg.proj_bias:
        rules.append((("custom_text_proj.bias", "embedding_proj_layer.bias"), "proj.bias", "raw"))
    if cfg.spatial_merge > 1:  # Qwen2.5-VL: the merger takes the connector's place
        rules += _qwen_vision_rules(cfg)
    else:
        # vision -> text connector (SmolVLM modality projection / PaliGemma projector)
        rules.append((("connector.modality_projection.proj.weight",
                       "multi_modal_projector.linear.weight"), "connector.weight", "linear"))
        if cfg.connector_bias:
            rules.append((("connector.modality_projection.proj.bias",
                           "multi_modal_projector.linear.bias"), "connector.bias", "raw"))
        vis_pre = (("vision_tower.vision_model.", "vision_model.")
                   if cfg.hf_layout == "paligemma" else ("vision_model.",))
        rules += _siglip_vision_rules(cfg, vis_pre)
    for i in range(cfg.text.layers):
        blk, lyr = f"layers.{i}.", f"layers.{i}."
        rules += [
            (tc(f"{lyr}self_attn.q_proj.weight"), blk + "attn.q.weight", "linear"),
            (tc(f"{lyr}self_attn.k_proj.weight"), blk + "attn.k.weight", "linear"),
            (tc(f"{lyr}self_attn.v_proj.weight"), blk + "attn.v.weight", "linear"),
            (tc(f"{lyr}self_attn.o_proj.weight"), blk + "attn.o.weight", "linear"),
            (tc(f"{lyr}input_layernorm.weight"), blk + "ln1.scale", "raw"),
            (tc(f"{lyr}post_attention_layernorm.weight"), blk + "ln2.scale", "raw"),
            (tc(f"{lyr}mlp.gate_proj.weight"), blk + "mlp.gate.weight", "linear"),
            (tc(f"{lyr}mlp.up_proj.weight"), blk + "mlp.up.weight", "linear"),
            (tc(f"{lyr}mlp.down_proj.weight"), blk + "mlp.down.weight", "linear"),
        ]
        if cfg.text.attn_qkv_bias:  # Qwen2-style text q/k/v biases
            rules += [(tc(f"{lyr}self_attn.{x}_proj.bias"), blk + f"attn.{x}.bias", "raw")
                      for x in ("q", "k", "v")]
    return rules


def _as_tensor(value) -> torch.Tensor:
    """A CPU tensor of an HF value: a torch tensor as it is, a numpy array
    (bf16 ones, which numpy cannot hand to torch, widened to f32)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu()
    arr = np.asarray(value)
    if arr.dtype.name == "bfloat16":
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.ascontiguousarray(arr))


def _transform(value: torch.Tensor, how: str) -> torch.Tensor:
    if how == "patch_conv3d":  # [H, C, t, k, k]: the image fills every frame
        value, how = value.float().sum(dim=2), "patch_conv"  # f32, as the JAX converter
    if how == "patch_conv":  # [H, C, k, k] -> [H, k*k*C], (row, col, channel) per patch
        h, c, kh, kw = value.shape
        return value.permute(0, 2, 3, 1).reshape(h, kh * kw * c)
    if how.startswith("qkv_"):  # the q, k or v third of a fused [3H, ...] tensor
        third, i = value.shape[0] // 3, int(how[-1])
        return value[i * third:(i + 1) * third]
    return value


def params_from_hf(state_dict: Mapping[str, Any],
                   cfg: ColVLMConfig) -> Tuple[Dict[str, torch.Tensor], Dict[str, List[str]]]:
    """The port's ``state_dict`` (CPU tensors in the port's dtypes) from an
    HF state dict of torch tensors or numpy arrays, and ``report`` =
    ``{"matched": [...], "missing": [...], "unused": [...]}`` as the JAX
    ``convert_state_dict`` reports it. Raises if a parameter of the port's
    model has no HF tensor or another shape."""
    normalized = {_strip_prefix(k): v for k, v in state_dict.items()}
    want = ColVLM(cfg, device="meta").state_dict()
    out: Dict[str, torch.Tensor] = {}
    matched: List[str] = []
    missing: List[str] = []
    consumed = set()  # a fused qkv key feeds three parameters: dropped after the loop
    for candidates, name, how in param_mapping(cfg):
        found = next((k for k in candidates if k in normalized), None)
        if found is None:
            missing.append(candidates[0])
            continue
        consumed.add(found)
        value = _transform(_as_tensor(normalized[found]), how)
        ref = want[name]
        if tuple(value.shape) != tuple(ref.shape):
            raise ValueError(f"{found}: shape {tuple(value.shape)}, the port's {name} is "
                             f"{tuple(ref.shape)}")
        out[name] = value.to(ref.dtype).contiguous()
        matched.append(candidates)
    for key in consumed:
        del normalized[key]
    if missing:
        raise ValueError(f"the HF state dict does not fit the port's ColVLM: missing "
                         f"{missing[:5]} (+{max(0, len(missing) - 5)} more)")
    return out, {"matched": matched, "missing": missing, "unused": sorted(normalized)}
