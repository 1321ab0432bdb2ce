"""The program's ``ColVLMConfig`` for a configuration file: the port's preset
the file names (its layer kinds: norms, biases, rotary, merge or shuffle),
with every size set from the file. For the two published configurations
the preset's sizes equal the file's but the ColQwen2.5 vision MLP (the
file's 3420, the preset's 5120)."""

from __future__ import annotations

import dataclasses
from typing import Dict

BACKENDS = {"qwen2_5_vl": "colqwen2.5", "idefics3": "colsmol"}


def program_config(cfg: Dict, remat: bool = False):
    from visual_rag_tpu_torch.models.colvlm import ColVLMConfig

    base = getattr(ColVLMConfig, cfg["preset"])()
    if cfg["model_type"] == "qwen2_5_vl":
        v, t = cfg["vision_config"], cfg
        merge = v["spatial_merge_size"]
        vision = dataclasses.replace(
            base.vision, hidden=v["hidden_size"], layers=v["depth"], heads=v["num_heads"],
            mlp_ratio=v["intermediate_size"] / v["hidden_size"],
            patch_pixels=3 * v["patch_size"] ** 2,
            max_patches=cfg["max_visual_tokens"] * merge * merge,
            window_side=v["window_size"] // v["patch_size"],
            full_attn_layers=tuple(v["fullatt_block_indexes"]))
        text_extra = {"mrope_section": tuple(cfg["rope_scaling"]["mrope_section"])}
    else:
        v, t = cfg["vision_config"], cfg["text_config"]
        merge = 1
        vision = dataclasses.replace(
            base.vision, hidden=v["hidden_size"], layers=v["num_hidden_layers"],
            heads=v["num_attention_heads"], mlp_ratio=v["intermediate_size"] / v["hidden_size"],
            patch_pixels=3 * v["patch_size"] ** 2, pixel_shuffle=cfg["scale_factor"])
        text_extra = {}
    text = dataclasses.replace(
        base.text, hidden=t["hidden_size"], layers=t["num_hidden_layers"],
        heads=t["num_attention_heads"], kv_heads=t["num_key_value_heads"],
        mlp_hidden=t["intermediate_size"], vocab=t["vocab_size"], rope_theta=t["rope_theta"],
        **text_extra)
    out = dataclasses.replace(base, vision=vision, text=text, spatial_merge=merge,
                              image_token_id=cfg["image_token_id"],
                              embed_dim=cfg["embedding_dim"], dtype=cfg["torch_dtype"],
                              remat=remat)
    if int(out.vision.hidden * out.vision.mlp_ratio) != v["intermediate_size"]:
        raise ValueError(f"{cfg['name']}: mlp_ratio does not give {v['intermediate_size']}")
    return out


def processor_for(cfg: Dict, pcfg):
    """The program's image processor as its embedder builds it."""
    from visual_rag_tpu_torch.models.processors import ImageProcessor

    ratio = max(pcfg.spatial_merge ** 2, pcfg.vision.pixel_shuffle ** 2, 1)
    return ImageProcessor(backend=BACKENDS[cfg["model_type"]],
                          image_token_id=pcfg.image_token_id,
                          patch_pixels=pcfg.vision.patch_pixels, vocab=pcfg.text.vocab,
                          max_visual_tokens=pcfg.vision.max_patches // ratio,
                          pixel_shuffle=pcfg.vision.pixel_shuffle)
