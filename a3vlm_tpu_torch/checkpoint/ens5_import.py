"""Full ens5 checkpoint ingestion: maps a consolidated A3VLM state dict —
whose vision towers were instantiated from THREE different libraries
(llama_ens5.py:284-322: HF Blip2Model, open_clip ViT + timm ConvNeXt trunk,
torch.hub DINOv2) — onto our unified pytrees. The highest-parity-risk
surface (SURVEY.md §7 hard part #1).

Name trees handled (all under the ``llma.`` prefix of the consolidated
format):
- ``clip.visual.*``                 open_clip CLIP ViT (fused in_proj qkv)
- ``openclip_convnext_xxl.*``       timm ConvNeXt trunk (+ head.norm)
- ``dinov2_vitg14.*``               hub DINOv2 (fused qkv, SwiGLU w12/w3,
                                    ls gamma)
- ``qformer.vision_model.*`` /
  ``qformer.qformer.*`` /
  ``qformer.query_tokens``          HF Blip2Model subtrees
- ``qformer_proj.* / visual_proj.* / start_img / end_img`` projectors+tags
- decoder ``layers.* / tok_embeddings / norm / output``
"""

from __future__ import annotations

from typing import Mapping

import numpy as np

from a3vlm_tpu_torch.checkpoint.torch_import import (
    _ln,
    _stack,
    _strip_prefix,
    import_blip2_vision,
    import_llama_consolidated,
    import_qformer,
)

Params = dict


def import_openclip_vit(sd: Mapping[str, np.ndarray], layers: int) -> Params:
    """open_clip CLIP visual tower (``visual.`` stripped or present):
    fused ``attn.in_proj_weight`` rows ordered [q; k; v], QuickGELU mlp."""
    sd = _strip_prefix(sd, "visual.")
    blocks = []
    for i in range(layers):
        p = f"transformer.resblocks.{i}"
        blocks.append(
            {
                "ln1": _ln(sd, f"{p}.ln_1"),
                "attn": {
                    "wqkv": {
                        "weight": sd[f"{p}.attn.in_proj_weight"].T,
                        "bias": sd[f"{p}.attn.in_proj_bias"],
                    },
                    "wo": {
                        "weight": sd[f"{p}.attn.out_proj.weight"].T,
                        "bias": sd[f"{p}.attn.out_proj.bias"],
                    },
                },
                "ln2": _ln(sd, f"{p}.ln_2"),
                "mlp": {
                    "fc1": {
                        "weight": sd[f"{p}.mlp.c_fc.weight"].T,
                        "bias": sd[f"{p}.mlp.c_fc.bias"],
                    },
                    "fc2": {
                        "weight": sd[f"{p}.mlp.c_proj.weight"].T,
                        "bias": sd[f"{p}.mlp.c_proj.bias"],
                    },
                },
            }
        )
    return {
        "patch_embed": {
            "kernel": sd["conv1.weight"].transpose(2, 3, 1, 0),
            "bias": None,  # open_clip conv1 has no bias
        },
        "class_embedding": sd["class_embedding"].reshape(-1),
        "positional_embedding": sd["positional_embedding"],
        "ln_pre": _ln(sd, "ln_pre"),
        "blocks": _stack(blocks),
        "ln_post": _ln(sd, "ln_post"),
    }


def import_timm_convnext(
    sd: Mapping[str, np.ndarray], depths: tuple[int, ...]
) -> Params:
    """timm ConvNeXt trunk (the ``visual.trunk`` of the open_clip model,
    with head pool/flatten disabled but head.norm kept,
    llama_ens5.py:311-315)."""
    stages = []
    for s, depth in enumerate(depths):
        stage: Params = {"blocks": []}
        if s > 0:
            stage["downsample"] = {
                "norm": _ln(sd, f"stages.{s}.downsample.0"),
                "conv": {
                    "kernel": sd[f"stages.{s}.downsample.1.weight"].transpose(
                        2, 3, 1, 0
                    ),
                    "bias": sd[f"stages.{s}.downsample.1.bias"],
                },
            }
        for i in range(depth):
            p = f"stages.{s}.blocks.{i}"
            stage["blocks"].append(
                {
                    "dwconv": {
                        "kernel": sd[f"{p}.conv_dw.weight"].transpose(
                            2, 3, 1, 0
                        ),
                        "bias": sd[f"{p}.conv_dw.bias"],
                    },
                    "norm": _ln(sd, f"{p}.norm"),
                    "pw1": {
                        "weight": sd[f"{p}.mlp.fc1.weight"].T,
                        "bias": sd[f"{p}.mlp.fc1.bias"],
                    },
                    "pw2": {
                        "weight": sd[f"{p}.mlp.fc2.weight"].T,
                        "bias": sd[f"{p}.mlp.fc2.bias"],
                    },
                    "gamma": sd[f"{p}.gamma"],
                }
            )
        stages.append(stage)
    out: Params = {
        "stem": {
            "conv": {
                "kernel": sd["stem.0.weight"].transpose(2, 3, 1, 0),
                "bias": sd["stem.0.bias"],
            },
            "norm": _ln(sd, "stem.1"),
        },
        "stages": stages,
    }
    if "head.norm.weight" in sd:
        out["head_norm"] = _ln(sd, "head.norm")
    return out


def import_dinov2_hub(
    sd: Mapping[str, np.ndarray], layers: int, swiglu: bool = True
) -> Params:
    """facebookresearch/dinov2 hub weights: fused ``attn.qkv``, LayerScale
    ``ls{1,2}.gamma``, SwiGLU ``mlp.w12``/``mlp.w3`` (giant)."""
    blocks = []
    for i in range(layers):
        p = f"blocks.{i}"
        if swiglu:
            mlp = {
                "fc1": {
                    "weight": sd[f"{p}.mlp.w12.weight"].T,
                    "bias": sd[f"{p}.mlp.w12.bias"],
                },
                "fc2": {
                    "weight": sd[f"{p}.mlp.w3.weight"].T,
                    "bias": sd[f"{p}.mlp.w3.bias"],
                },
            }
        else:
            mlp = {
                "fc1": {
                    "weight": sd[f"{p}.mlp.fc1.weight"].T,
                    "bias": sd[f"{p}.mlp.fc1.bias"],
                },
                "fc2": {
                    "weight": sd[f"{p}.mlp.fc2.weight"].T,
                    "bias": sd[f"{p}.mlp.fc2.bias"],
                },
            }
        blocks.append(
            {
                "ln1": _ln(sd, f"{p}.norm1"),
                "attn": {
                    "wqkv": {
                        "weight": sd[f"{p}.attn.qkv.weight"].T,
                        "bias": sd[f"{p}.attn.qkv.bias"],
                    },
                    "wo": {
                        "weight": sd[f"{p}.attn.proj.weight"].T,
                        "bias": sd[f"{p}.attn.proj.bias"],
                    },
                },
                "ln2": _ln(sd, f"{p}.norm2"),
                "mlp": mlp,
                "ls1": sd[f"{p}.ls1.gamma"],
                "ls2": sd[f"{p}.ls2.gamma"],
            }
        )
    return {
        "patch_embed": {
            "kernel": sd["patch_embed.proj.weight"].transpose(2, 3, 1, 0),
            "bias": sd["patch_embed.proj.bias"],
        },
        "class_embedding": sd["cls_token"].reshape(-1),
        "positional_embedding": sd["pos_embed"].reshape(
            -1, sd["cls_token"].shape[-1]
        ),
        "blocks": _stack(blocks),
        "ln_post": _ln(sd, "norm"),
    }


def _proj(sd: Mapping[str, np.ndarray], name: str) -> Params:
    """nn.Sequential(Linear, LayerNorm) projector (llama_ens5.py:325-333)."""
    return {
        "linear": {
            "weight": np.asarray(sd[f"{name}.0.weight"]).T,
            "bias": np.asarray(sd[f"{name}.0.bias"]),
        },
        "ln": {
            "weight": np.asarray(sd[f"{name}.1.weight"]),
            "bias": np.asarray(sd[f"{name}.1.bias"]),
        },
    }


def import_ens5_consolidated(sd: Mapping[str, np.ndarray], cfg) -> Params:
    """Merged consolidated A3VLM state dict -> complete ens5 params tree.
    ``cfg``: models.ens5.Ens5Config (layer counts taken from it)."""
    sd = _strip_prefix(dict(sd), "llma.")

    def sub(prefix: str) -> dict:
        return {
            k[len(prefix):]: np.asarray(v)
            for k, v in sd.items()
            if k.startswith(prefix)
        }

    params: Params = {
        "llama": import_llama_consolidated(sd, n_layers=cfg.llama.n_layers,
                                           prefix=""),
        "clip": import_openclip_vit(sub("clip."), layers=cfg.clip.layers),
        "convnext": import_timm_convnext(
            sub("openclip_convnext_xxl."), depths=cfg.convnext.depths
        ),
        "dinov2": import_dinov2_hub(
            sub("dinov2_vitg14."), layers=cfg.dinov2.layers,
            swiglu=cfg.dinov2.use_swiglu,
        ),
        "blip2_vision": import_blip2_vision(
            sub("qformer.vision_model."), layers=cfg.blip2_vision.layers
        ),
        "qformer": import_qformer(
            sub("qformer.qformer."),
            layers=cfg.qformer.layers,
            cross_attention_frequency=cfg.qformer.cross_attention_frequency,
            query_tokens=sd["qformer.query_tokens"],
        ),
        "qformer_proj": _proj(sd, "qformer_proj"),
        "visual_proj": _proj(sd, "visual_proj"),
        "start_img": np.asarray(sd["start_img"]),
        "end_img": np.asarray(sd["end_img"]),
    }
    if "start_depth_img" in sd:  # the 2-image variant
        params["start_depth_img"] = np.asarray(sd["start_depth_img"])
        params["end_depth_img"] = np.asarray(sd["end_depth_img"])
    return params


def has_ens5_towers(sd: Mapping[str, np.ndarray]) -> bool:
    return any(
        k.startswith(("llma.clip.", "clip."))
        or k.startswith(("llma.dinov2_vitg14.", "dinov2_vitg14."))
        for k in sd
    )
