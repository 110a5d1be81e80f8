"""Checkpoint exporters — interop back to the reference's torch formats:

- ``export_consolidated``: our decoder pytree -> ``consolidated.XX-of-YY
  .model.pth`` TP shards (the reference's native format,
  util/tensor_parallel.py:40-45), loadable by LLaMA2-Accessory.
- ``export_hf_llama``: -> HuggingFace LlamaForCausalLM state dict (the
  tools/convert_weights_to_hf.py equivalent), with the interleaved->
  half-split rotary permutation.
- ``extract_diff`` / ``apply_diff``: delta checkpoints
  (tools/weight_operate.py:17-58).
"""

from __future__ import annotations

from pathlib import Path
from typing import Mapping

import numpy as np

from a3vlm_tpu_torch.checkpoint.torch_import import split_consolidated_shards


def decoder_params_to_consolidated(params) -> dict[str, np.ndarray]:
    """Our llama pytree (stacked layers, [in,out] weights) -> flat
    ``llma.``-prefixed torch-layout ([out,in]) state dict."""
    out: dict[str, np.ndarray] = {}
    out["llma.tok_embeddings.weight"] = np.asarray(
        params["tok_embeddings"]["weight"], np.float32
    )
    out["llma.norm.weight"] = np.asarray(params["norm"]["weight"], np.float32)
    out["llma.output.weight"] = np.asarray(
        params["output"]["weight"], np.float32
    ).T
    layers = params["layers"]
    n_layers = np.asarray(layers["attention_norm"]["weight"]).shape[0]
    for i in range(n_layers):
        for w in ("wq", "wk", "wv", "wo"):
            out[f"llma.layers.{i}.attention.{w}.weight"] = np.asarray(
                layers["attention"][w]["weight"][i], np.float32
            ).T
        for w in ("w1", "w2", "w3"):
            out[f"llma.layers.{i}.feed_forward.{w}.weight"] = np.asarray(
                layers["feed_forward"][w]["weight"][i], np.float32
            ).T
        out[f"llma.layers.{i}.attention_norm.weight"] = np.asarray(
            layers["attention_norm"]["weight"][i], np.float32
        )
        out[f"llma.layers.{i}.ffn_norm.weight"] = np.asarray(
            layers["ffn_norm"]["weight"][i], np.float32
        )
    return out


def export_consolidated(params, out_dir: str, mp_size: int = 1) -> list[str]:
    import torch

    sd = decoder_params_to_consolidated(params)
    shards = split_consolidated_shards(sd, mp_size)
    Path(out_dir).mkdir(parents=True, exist_ok=True)
    paths = []
    for rank, shard in enumerate(shards):
        p = Path(out_dir) / (
            f"consolidated.{rank:02d}-of-{mp_size:02d}.model.pth"
        )
        torch.save(
            {"model": {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in shard.items()}}, p
        )
        paths.append(str(p))
    return paths


def _hf_rope_permute(w_t: np.ndarray, n_heads: int) -> np.ndarray:
    """Meta interleaved [in, out] -> HF half-split [in, out] (the forward
    direction of checkpoint/torch_import._hf_rope_unpermute)."""
    in_dim, out_dim = w_t.shape
    hd = out_dim // n_heads
    w = w_t.T.reshape(n_heads, hd // 2, 2, in_dim)
    w = w.transpose(0, 2, 1, 3).reshape(out_dim, in_dim)
    return w.T


def export_hf_llama(params, n_heads: int, n_kv_heads: int | None = None):
    """-> {hf_name: np.ndarray [out,in]} (tools/convert_weights_to_hf.py)."""
    n_kv = n_kv_heads or n_heads
    sd: dict[str, np.ndarray] = {}
    sd["model.embed_tokens.weight"] = np.asarray(
        params["tok_embeddings"]["weight"], np.float32
    )
    sd["model.norm.weight"] = np.asarray(params["norm"]["weight"], np.float32)
    sd["lm_head.weight"] = np.asarray(params["output"]["weight"], np.float32).T
    layers = params["layers"]
    n_layers = np.asarray(layers["attention_norm"]["weight"]).shape[0]
    for i in range(n_layers):
        att = layers["attention"]
        sd[f"model.layers.{i}.self_attn.q_proj.weight"] = _hf_rope_permute(
            np.asarray(att["wq"]["weight"][i], np.float32), n_heads
        ).T
        sd[f"model.layers.{i}.self_attn.k_proj.weight"] = _hf_rope_permute(
            np.asarray(att["wk"]["weight"][i], np.float32), n_kv
        ).T
        sd[f"model.layers.{i}.self_attn.v_proj.weight"] = np.asarray(
            att["wv"]["weight"][i], np.float32
        ).T
        sd[f"model.layers.{i}.self_attn.o_proj.weight"] = np.asarray(
            att["wo"]["weight"][i], np.float32
        ).T
        ff = layers["feed_forward"]
        sd[f"model.layers.{i}.mlp.gate_proj.weight"] = np.asarray(
            ff["w1"]["weight"][i], np.float32
        ).T
        sd[f"model.layers.{i}.mlp.down_proj.weight"] = np.asarray(
            ff["w2"]["weight"][i], np.float32
        ).T
        sd[f"model.layers.{i}.mlp.up_proj.weight"] = np.asarray(
            ff["w3"]["weight"][i], np.float32
        ).T
        sd[f"model.layers.{i}.input_layernorm.weight"] = np.asarray(
            layers["attention_norm"]["weight"][i], np.float32
        )
        sd[f"model.layers.{i}.post_attention_layernorm.weight"] = np.asarray(
            layers["ffn_norm"]["weight"][i], np.float32
        )
    return sd


def ens5_params_to_consolidated(params, cfg) -> dict[str, np.ndarray]:
    """Complete ens5 params tree -> consolidated ``llma.``-prefixed state
    dict in the reference's torch module naming (the inverse of
    checkpoint/ens5_import.import_ens5_consolidated): open_clip names for
    the CLIP tower, timm names for ConvNeXt, hub names for DINOv2, HF names
    for BLIP-2 — so trained checkpoints load back into LLaMA2-Accessory."""
    sd = decoder_params_to_consolidated(params["llama"])

    def put(name, arr, transpose=False):
        arr = np.asarray(arr, np.float32)
        sd[f"llma.{name}"] = arr.T if transpose else arr

    # CLIP (open_clip visual.*)
    clip = params["clip"]
    put("clip.visual.conv1.weight",
        np.asarray(clip["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("clip.visual.class_embedding", clip["class_embedding"])
    put("clip.visual.positional_embedding", clip["positional_embedding"])
    for ln, name in (("ln_pre", "ln_pre"), ("ln_post", "ln_post")):
        put(f"clip.visual.{name}.weight", clip[ln]["weight"])
        put(f"clip.visual.{name}.bias", clip[ln]["bias"])
    L = np.asarray(clip["blocks"]["ln1"]["weight"]).shape[0]
    for i in range(L):
        p = f"clip.visual.transformer.resblocks.{i}"
        b = clip["blocks"]
        put(f"{p}.ln_1.weight", b["ln1"]["weight"][i])
        put(f"{p}.ln_1.bias", b["ln1"]["bias"][i])
        put(f"{p}.attn.in_proj_weight", b["attn"]["wqkv"]["weight"][i],
            transpose=True)
        put(f"{p}.attn.in_proj_bias", b["attn"]["wqkv"]["bias"][i])
        put(f"{p}.attn.out_proj.weight", b["attn"]["wo"]["weight"][i],
            transpose=True)
        put(f"{p}.attn.out_proj.bias", b["attn"]["wo"]["bias"][i])
        put(f"{p}.ln_2.weight", b["ln2"]["weight"][i])
        put(f"{p}.ln_2.bias", b["ln2"]["bias"][i])
        put(f"{p}.mlp.c_fc.weight", b["mlp"]["fc1"]["weight"][i],
            transpose=True)
        put(f"{p}.mlp.c_fc.bias", b["mlp"]["fc1"]["bias"][i])
        put(f"{p}.mlp.c_proj.weight", b["mlp"]["fc2"]["weight"][i],
            transpose=True)
        put(f"{p}.mlp.c_proj.bias", b["mlp"]["fc2"]["bias"][i])

    # ConvNeXt (timm trunk)
    cn = params["convnext"]
    put("openclip_convnext_xxl.stem.0.weight",
        np.asarray(cn["stem"]["conv"]["kernel"]).transpose(3, 2, 0, 1))
    put("openclip_convnext_xxl.stem.0.bias", cn["stem"]["conv"]["bias"])
    put("openclip_convnext_xxl.stem.1.weight", cn["stem"]["norm"]["weight"])
    put("openclip_convnext_xxl.stem.1.bias", cn["stem"]["norm"]["bias"])
    for s, stage in enumerate(cn["stages"]):
        if s > 0:
            ds = stage["downsample"]
            put(f"openclip_convnext_xxl.stages.{s}.downsample.0.weight",
                ds["norm"]["weight"])
            put(f"openclip_convnext_xxl.stages.{s}.downsample.0.bias",
                ds["norm"]["bias"])
            put(f"openclip_convnext_xxl.stages.{s}.downsample.1.weight",
                np.asarray(ds["conv"]["kernel"]).transpose(3, 2, 0, 1))
            put(f"openclip_convnext_xxl.stages.{s}.downsample.1.bias",
                ds["conv"]["bias"])
        for i, blk in enumerate(stage["blocks"]):
            p = f"openclip_convnext_xxl.stages.{s}.blocks.{i}"
            put(f"{p}.conv_dw.weight",
                np.asarray(blk["dwconv"]["kernel"]).transpose(3, 2, 0, 1))
            put(f"{p}.conv_dw.bias", blk["dwconv"]["bias"])
            put(f"{p}.norm.weight", blk["norm"]["weight"])
            put(f"{p}.norm.bias", blk["norm"]["bias"])
            put(f"{p}.mlp.fc1.weight", blk["pw1"]["weight"], transpose=True)
            put(f"{p}.mlp.fc1.bias", blk["pw1"]["bias"])
            put(f"{p}.mlp.fc2.weight", blk["pw2"]["weight"], transpose=True)
            put(f"{p}.mlp.fc2.bias", blk["pw2"]["bias"])
            put(f"{p}.gamma", blk["gamma"])
    if "head_norm" in cn:
        put("openclip_convnext_xxl.head.norm.weight",
            cn["head_norm"]["weight"])
        put("openclip_convnext_xxl.head.norm.bias", cn["head_norm"]["bias"])

    # DINOv2 (hub)
    d = params["dinov2"]
    put("dinov2_vitg14.patch_embed.proj.weight",
        np.asarray(d["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("dinov2_vitg14.patch_embed.proj.bias", d["patch_embed"]["bias"])
    put("dinov2_vitg14.cls_token",
        np.asarray(d["class_embedding"]).reshape(1, 1, -1))
    put("dinov2_vitg14.pos_embed",
        np.asarray(d["positional_embedding"])[None])
    put("dinov2_vitg14.norm.weight", d["ln_post"]["weight"])
    put("dinov2_vitg14.norm.bias", d["ln_post"]["bias"])
    L = np.asarray(d["blocks"]["ln1"]["weight"]).shape[0]
    swiglu = "ls1" in d["blocks"]
    for i in range(L):
        p = f"dinov2_vitg14.blocks.{i}"
        b = d["blocks"]
        put(f"{p}.norm1.weight", b["ln1"]["weight"][i])
        put(f"{p}.norm1.bias", b["ln1"]["bias"][i])
        put(f"{p}.attn.qkv.weight", b["attn"]["wqkv"]["weight"][i],
            transpose=True)
        put(f"{p}.attn.qkv.bias", b["attn"]["wqkv"]["bias"][i])
        put(f"{p}.attn.proj.weight", b["attn"]["wo"]["weight"][i],
            transpose=True)
        put(f"{p}.attn.proj.bias", b["attn"]["wo"]["bias"][i])
        put(f"{p}.norm2.weight", b["ln2"]["weight"][i])
        put(f"{p}.norm2.bias", b["ln2"]["bias"][i])
        put(f"{p}.mlp.w12.weight", b["mlp"]["fc1"]["weight"][i],
            transpose=True)
        put(f"{p}.mlp.w12.bias", b["mlp"]["fc1"]["bias"][i])
        put(f"{p}.mlp.w3.weight", b["mlp"]["fc2"]["weight"][i],
            transpose=True)
        put(f"{p}.mlp.w3.bias", b["mlp"]["fc2"]["bias"][i])
        put(f"{p}.ls1.gamma", b["ls1"][i])
        put(f"{p}.ls2.gamma", b["ls2"][i])

    # BLIP-2 vision (HF names under qformer.vision_model.)
    bv = params["blip2_vision"]
    put("qformer.vision_model.embeddings.patch_embedding.weight",
        np.asarray(bv["patch_embed"]["kernel"]).transpose(3, 2, 0, 1))
    put("qformer.vision_model.embeddings.patch_embedding.bias",
        bv["patch_embed"]["bias"])
    put("qformer.vision_model.embeddings.class_embedding",
        np.asarray(bv["class_embedding"]).reshape(1, 1, -1))
    put("qformer.vision_model.embeddings.position_embedding",
        np.asarray(bv["positional_embedding"])[None])
    put("qformer.vision_model.post_layernorm.weight",
        bv["ln_post"]["weight"])
    put("qformer.vision_model.post_layernorm.bias", bv["ln_post"]["bias"])
    L = np.asarray(bv["blocks"]["ln1"]["weight"]).shape[0]
    for i in range(L):
        p = f"qformer.vision_model.encoder.layers.{i}"
        b = bv["blocks"]
        put(f"{p}.layer_norm1.weight", b["ln1"]["weight"][i])
        put(f"{p}.layer_norm1.bias", b["ln1"]["bias"][i])
        put(f"{p}.self_attn.qkv.weight", b["attn"]["wqkv"]["weight"][i],
            transpose=True)
        put(f"{p}.self_attn.qkv.bias", b["attn"]["wqkv"]["bias"][i])
        put(f"{p}.self_attn.projection.weight", b["attn"]["wo"]["weight"][i],
            transpose=True)
        put(f"{p}.self_attn.projection.bias", b["attn"]["wo"]["bias"][i])
        put(f"{p}.layer_norm2.weight", b["ln2"]["weight"][i])
        put(f"{p}.layer_norm2.bias", b["ln2"]["bias"][i])
        put(f"{p}.mlp.fc1.weight", b["mlp"]["fc1"]["weight"][i],
            transpose=True)
        put(f"{p}.mlp.fc1.bias", b["mlp"]["fc1"]["bias"][i])
        put(f"{p}.mlp.fc2.weight", b["mlp"]["fc2"]["weight"][i],
            transpose=True)
        put(f"{p}.mlp.fc2.bias", b["mlp"]["fc2"]["bias"][i])

    # Q-Former (HF names under qformer.qformer.)
    qf = params["qformer"]
    put("qformer.query_tokens",
        np.asarray(qf["query_tokens"])[None])
    put("qformer.qformer.layernorm.weight", qf["layernorm"]["weight"])
    put("qformer.qformer.layernorm.bias", qf["layernorm"]["bias"])
    for i, lp in enumerate(qf["layers"]):
        p = f"qformer.qformer.encoder.layer.{i}"
        for src, dst in (
            ("q", "attention.attention.query"),
            ("k", "attention.attention.key"),
            ("v", "attention.attention.value"),
            ("out", "attention.output.dense"),
        ):
            put(f"{p}.{dst}.weight", lp["self_attn"][src]["weight"],
                transpose=True)
            put(f"{p}.{dst}.bias", lp["self_attn"][src]["bias"])
        put(f"{p}.attention.output.LayerNorm.weight",
            lp["self_attn"]["ln"]["weight"])
        put(f"{p}.attention.output.LayerNorm.bias",
            lp["self_attn"]["ln"]["bias"])
        if "cross_attn" in lp:
            for src, dst in (
                ("q", "crossattention.attention.query"),
                ("k", "crossattention.attention.key"),
                ("v", "crossattention.attention.value"),
                ("out", "crossattention.output.dense"),
            ):
                put(f"{p}.{dst}.weight", lp["cross_attn"][src]["weight"],
                    transpose=True)
                put(f"{p}.{dst}.bias", lp["cross_attn"][src]["bias"])
            put(f"{p}.crossattention.output.LayerNorm.weight",
                lp["cross_attn"]["ln"]["weight"])
            put(f"{p}.crossattention.output.LayerNorm.bias",
                lp["cross_attn"]["ln"]["bias"])
        put(f"{p}.intermediate_query.dense.weight",
            lp["ffn"]["fc1"]["weight"], transpose=True)
        put(f"{p}.intermediate_query.dense.bias", lp["ffn"]["fc1"]["bias"])
        put(f"{p}.output_query.dense.weight", lp["ffn"]["fc2"]["weight"],
            transpose=True)
        put(f"{p}.output_query.dense.bias", lp["ffn"]["fc2"]["bias"])
        put(f"{p}.output_query.LayerNorm.weight", lp["ffn"]["ln"]["weight"])
        put(f"{p}.output_query.LayerNorm.bias", lp["ffn"]["ln"]["bias"])

    # projectors + tags (nn.Sequential naming, llama_ens5.py:325-339)
    for name in ("qformer_proj", "visual_proj"):
        put(f"{name}.0.weight", params[name]["linear"]["weight"],
            transpose=True)
        put(f"{name}.0.bias", params[name]["linear"]["bias"])
        put(f"{name}.1.weight", params[name]["ln"]["weight"])
        put(f"{name}.1.bias", params[name]["ln"]["bias"])
    for tag in ("start_img", "end_img", "start_depth_img", "end_depth_img"):
        if tag in params:
            put(tag, params[tag])
    return sd


def extract_diff(
    finetuned: Mapping[str, np.ndarray], base: Mapping[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """Delta checkpoint = finetuned - base for shared keys; finetuned-only
    keys kept as-is (tools/weight_operate.py:17-58)."""
    out = {}
    for k, v in finetuned.items():
        v = np.asarray(v)
        out[k] = v - np.asarray(base[k]) if k in base else v
    return out
