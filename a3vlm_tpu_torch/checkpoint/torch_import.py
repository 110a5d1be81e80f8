"""Torch-checkpoint ingestion: maps released torch weights onto numpy
parameter trees in the JAX package's layout, which
``checkpoint/bridge.params_from_numpy`` turns into the port's tensors (the
highest-parity-risk component, SURVEY.md §7 hard-part #1). A copy of the
JAX package's module of the same name; ``_stack`` walks the trees itself.

Covers:
- HF module trees for the four vision towers (CLIPVisionModel,
  Blip2VisionModel, Blip2QFormerModel, Dinov2Model, ConvNextModel) — the
  same architectures the reference instantiates from transformers/open_clip/
  torch.hub (llama_ens5.py:284-322).
- HF LlamaForCausalLM (with the rotary half-split -> interleaved
  permutation).
- the reference's consolidated TP checkpoint format
  ``consolidated.XX-of-YY.model.pth`` incl. shard merging and ``llma.``
  prefixes (util/tensor_parallel.py:34-161 semantics) and diff checkpoints.

All functions take a flat ``{name: np.ndarray}`` state dict (use
``state_dict_numpy`` on a torch module); only ``load_consolidated_dir``
reads the files with torch.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np

Params = dict[str, Any]


def state_dict_numpy(module_or_sd) -> dict[str, np.ndarray]:
    """torch module / state_dict -> {name: float32 numpy}."""
    sd = (
        module_or_sd.state_dict()
        if hasattr(module_or_sd, "state_dict")
        else module_or_sd
    )
    return {k: np.asarray(v.detach().float().cpu().numpy()) for k, v in sd.items()}


def _lin(sd, name):
    """torch Linear -> {weight [in,out], bias} (transposed to x @ w)."""
    out = {"weight": sd[f"{name}.weight"].T}
    if f"{name}.bias" in sd:
        out["bias"] = sd[f"{name}.bias"]
    return out


def _ln(sd, name):
    return {"weight": sd[f"{name}.weight"], "bias": sd[f"{name}.bias"]}


def _stack(dicts: list[Params]) -> Params:
    """list of identical pytrees -> single pytree with stacked leaves
    (dicts and lists walked, None kept, every other leaf np.stack-ed)."""
    first = dicts[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: _stack([d[k] for d in dicts]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_stack([d[i] for d in dicts])
                           for i in range(len(first)))
    return np.stack(dicts)


# ---------------------------------------------------------------------------
# ViT towers
# ---------------------------------------------------------------------------


def import_clip_vision(sd: Mapping[str, np.ndarray], layers: int) -> Params:
    """HF CLIPVisionModel (``vision_model.`` prefix stripped or present)."""
    sd = _strip_prefix(sd, "vision_model.")
    blocks = []
    for i in range(layers):
        p = f"encoder.layers.{i}"
        q = _lin(sd, f"{p}.self_attn.q_proj")
        k = _lin(sd, f"{p}.self_attn.k_proj")
        v = _lin(sd, f"{p}.self_attn.v_proj")
        blocks.append(
            {
                "ln1": _ln(sd, f"{p}.layer_norm1"),
                "attn": {
                    "wqkv": {
                        "weight": np.concatenate(
                            [q["weight"], k["weight"], v["weight"]], axis=1
                        ),
                        "bias": np.concatenate(
                            [q["bias"], k["bias"], v["bias"]], axis=0
                        ),
                    },
                    "wo": _lin(sd, f"{p}.self_attn.out_proj"),
                },
                "ln2": _ln(sd, f"{p}.layer_norm2"),
                "mlp": {
                    "fc1": _lin(sd, f"{p}.mlp.fc1"),
                    "fc2": _lin(sd, f"{p}.mlp.fc2"),
                },
            }
        )
    return {
        "patch_embed": {
            # [W,3,P,P] -> HWIO
            "kernel": sd["embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0),
            "bias": sd.get("embeddings.patch_embedding.bias"),
        },
        "class_embedding": sd["embeddings.class_embedding"].reshape(-1),
        "positional_embedding": sd["embeddings.position_embedding.weight"],
        "ln_pre": _ln(sd, "pre_layrnorm"),  # (sic) HF attribute name
        "blocks": _stack(blocks),
        "ln_post": _ln(sd, "post_layernorm"),
    }


def import_blip2_vision(sd: Mapping[str, np.ndarray], layers: int) -> Params:
    """HF Blip2VisionModel: fused qkv linear, rows ordered [q; k; v]."""
    sd = _strip_prefix(sd, "vision_model.")
    blocks = []
    for i in range(layers):
        p = f"encoder.layers.{i}"
        blocks.append(
            {
                "ln1": _ln(sd, f"{p}.layer_norm1"),
                "attn": {
                    "wqkv": _lin(sd, f"{p}.self_attn.qkv"),
                    "wo": _lin(sd, f"{p}.self_attn.projection"),
                },
                "ln2": _ln(sd, f"{p}.layer_norm2"),
                "mlp": {
                    "fc1": _lin(sd, f"{p}.mlp.fc1"),
                    "fc2": _lin(sd, f"{p}.mlp.fc2"),
                },
            }
        )
    return {
        "patch_embed": {
            "kernel": sd["embeddings.patch_embedding.weight"].transpose(2, 3, 1, 0),
            "bias": sd.get("embeddings.patch_embedding.bias"),
        },
        "class_embedding": sd["embeddings.class_embedding"].reshape(-1),
        "positional_embedding": sd["embeddings.position_embedding"].reshape(
            -1, sd["embeddings.class_embedding"].shape[-1]
        ),
        "blocks": _stack(blocks),
        "ln_post": _ln(sd, "post_layernorm"),
    }


def import_dinov2(
    sd: Mapping[str, np.ndarray], layers: int, swiglu: bool = True
) -> Params:
    """HF Dinov2Model (facebookresearch hub weights share this tree)."""
    blocks = []
    for i in range(layers):
        p = f"encoder.layer.{i}"
        q = _lin(sd, f"{p}.attention.attention.query")
        k = _lin(sd, f"{p}.attention.attention.key")
        v = _lin(sd, f"{p}.attention.attention.value")
        if swiglu:
            mlp = {
                "fc1": _lin(sd, f"{p}.mlp.weights_in"),
                "fc2": _lin(sd, f"{p}.mlp.weights_out"),
            }
        else:
            mlp = {
                "fc1": _lin(sd, f"{p}.mlp.fc1"),
                "fc2": _lin(sd, f"{p}.mlp.fc2"),
            }
        blocks.append(
            {
                "ln1": _ln(sd, f"{p}.norm1"),
                "attn": {
                    "wqkv": {
                        "weight": np.concatenate(
                            [q["weight"], k["weight"], v["weight"]], axis=1
                        ),
                        "bias": np.concatenate(
                            [q["bias"], k["bias"], v["bias"]], axis=0
                        ),
                    },
                    "wo": _lin(sd, f"{p}.attention.output.dense"),
                },
                "ln2": _ln(sd, f"{p}.norm2"),
                "mlp": mlp,
                "ls1": sd[f"{p}.layer_scale1.lambda1"],
                "ls2": sd[f"{p}.layer_scale2.lambda1"],
            }
        )
    return {
        "patch_embed": {
            "kernel": sd[
                "embeddings.patch_embeddings.projection.weight"
            ].transpose(2, 3, 1, 0),
            "bias": sd["embeddings.patch_embeddings.projection.bias"],
        },
        "class_embedding": sd["embeddings.cls_token"].reshape(-1),
        "positional_embedding": sd["embeddings.position_embeddings"].reshape(
            -1, sd["embeddings.cls_token"].shape[-1]
        ),
        "blocks": _stack(blocks),
        "ln_post": _ln(sd, "layernorm"),
    }


def import_convnext(
    sd: Mapping[str, np.ndarray], depths: tuple[int, ...]
) -> Params:
    """HF ConvNextModel. The final pooled layernorm is NOT the feature-map
    head norm; set cfg.head_norm=False when comparing to HF."""
    stages = []
    for s, depth in enumerate(depths):
        stage: Params = {"blocks": []}
        if s > 0:
            stage["downsample"] = {
                "norm": _ln(sd, f"encoder.stages.{s}.downsampling_layer.0"),
                "conv": {
                    "kernel": sd[
                        f"encoder.stages.{s}.downsampling_layer.1.weight"
                    ].transpose(2, 3, 1, 0),
                    "bias": sd[f"encoder.stages.{s}.downsampling_layer.1.bias"],
                },
            }
        for i in range(depth):
            p = f"encoder.stages.{s}.layers.{i}"
            stage["blocks"].append(
                {
                    "dwconv": {
                        # [dim,1,7,7] -> [7,7,1,dim]
                        "kernel": sd[f"{p}.dwconv.weight"].transpose(2, 3, 1, 0),
                        "bias": sd[f"{p}.dwconv.bias"],
                    },
                    "norm": _ln(sd, f"{p}.layernorm"),
                    "pw1": _lin(sd, f"{p}.pwconv1"),
                    "pw2": _lin(sd, f"{p}.pwconv2"),
                    "gamma": sd[f"{p}.layer_scale_parameter"],
                }
            )
        stages.append(stage)
    return {
        "stem": {
            "conv": {
                "kernel": sd["embeddings.patch_embeddings.weight"].transpose(
                    2, 3, 1, 0
                ),
                "bias": sd["embeddings.patch_embeddings.bias"],
            },
            "norm": _ln(sd, "embeddings.layernorm"),
        },
        "stages": stages,
    }


def import_qformer(
    sd: Mapping[str, np.ndarray],
    layers: int,
    cross_attention_frequency: int = 2,
    query_tokens: np.ndarray | None = None,
) -> Params:
    """HF Blip2QFormerModel (+ the Blip2Model-level ``query_tokens``)."""
    out_layers = []
    for i in range(layers):
        p = f"encoder.layer.{i}"
        lp: Params = {
            "self_attn": {
                "q": _lin(sd, f"{p}.attention.attention.query"),
                "k": _lin(sd, f"{p}.attention.attention.key"),
                "v": _lin(sd, f"{p}.attention.attention.value"),
                "out": _lin(sd, f"{p}.attention.output.dense"),
                "ln": _ln(sd, f"{p}.attention.output.LayerNorm"),
            },
            "ffn": {
                "fc1": _lin(sd, f"{p}.intermediate_query.dense"),
                "fc2": _lin(sd, f"{p}.output_query.dense"),
                "ln": _ln(sd, f"{p}.output_query.LayerNorm"),
            },
        }
        if i % cross_attention_frequency == 0:
            lp["cross_attn"] = {
                "q": _lin(sd, f"{p}.crossattention.attention.query"),
                "k": _lin(sd, f"{p}.crossattention.attention.key"),
                "v": _lin(sd, f"{p}.crossattention.attention.value"),
                "out": _lin(sd, f"{p}.crossattention.output.dense"),
                "ln": _ln(sd, f"{p}.crossattention.output.LayerNorm"),
            }
        out_layers.append(lp)
    if query_tokens is None:
        query_tokens = sd["query_tokens"]
    return {
        "query_tokens": np.asarray(query_tokens).reshape(
            -1, sd["layernorm.weight"].shape[0]
        ),
        "layernorm": _ln(sd, "layernorm"),
        "layers": out_layers,
    }


# ---------------------------------------------------------------------------
# LLaMA
# ---------------------------------------------------------------------------


def _hf_rope_unpermute(w_t: np.ndarray, n_heads: int) -> np.ndarray:
    """HF stores q/k for half-split rotary; convert [in, out] (already
    transposed) back to Meta's interleaved-pair layout."""
    in_dim, out_dim = w_t.shape
    hd = out_dim // n_heads
    w = w_t.T.reshape(n_heads, 2, hd // 2, in_dim)
    w = w.transpose(0, 2, 1, 3).reshape(out_dim, in_dim)
    return w.T


def import_llama_hf(sd: Mapping[str, np.ndarray], n_layers: int,
                    n_heads: int, n_kv_heads: int | None = None) -> Params:
    """HF LlamaForCausalLM -> our decoder params (models/llama.py tree)."""
    n_kv = n_kv_heads or n_heads
    layers = []
    for i in range(n_layers):
        p = f"model.layers.{i}"
        layers.append(
            {
                "attention": {
                    "wq": {
                        "weight": _hf_rope_unpermute(
                            sd[f"{p}.self_attn.q_proj.weight"].T, n_heads
                        )
                    },
                    "wk": {
                        "weight": _hf_rope_unpermute(
                            sd[f"{p}.self_attn.k_proj.weight"].T, n_kv
                        )
                    },
                    "wv": {"weight": sd[f"{p}.self_attn.v_proj.weight"].T},
                    "wo": {"weight": sd[f"{p}.self_attn.o_proj.weight"].T},
                },
                "feed_forward": {
                    "w1": {"weight": sd[f"{p}.mlp.gate_proj.weight"].T},
                    "w2": {"weight": sd[f"{p}.mlp.down_proj.weight"].T},
                    "w3": {"weight": sd[f"{p}.mlp.up_proj.weight"].T},
                },
                "attention_norm": {"weight": sd[f"{p}.input_layernorm.weight"]},
                "ffn_norm": {"weight": sd[f"{p}.post_attention_layernorm.weight"]},
            }
        )
    return {
        "tok_embeddings": {"weight": sd["model.embed_tokens.weight"]},
        "layers": _stack(layers),
        "norm": {"weight": sd["model.norm.weight"]},
        "output": {"weight": sd["lm_head.weight"].T},
    }


# the reference's TP shard axes (util/tensor_parallel.py:34-38), expressed on
# torch [out, in] weights: ColumnParallel shards dim 0, RowParallel dim 1,
# ParallelEmbedding dim 1.
_COLUMN_PAT = re.compile(
    r"\.(wq|wk|wv|w1|w3)\.weight$|(^|\.)output\.weight$"
)
_ROW_PAT = re.compile(r"\.(wo|w2)\.weight$")
_EMBED_PAT = re.compile(r"tok_embeddings\.weight$")


def merge_consolidated_shards(
    shards: list[Mapping[str, np.ndarray]]
) -> dict[str, np.ndarray]:
    """Merge per-MP-rank ``consolidated.XX-of-YY`` state dicts into a full
    state dict (the merge direction of util/tensor_parallel.py:83-130).
    Non-sharded params must be replicas; the first shard's copy is used."""
    merged = {}
    for key in shards[0]:
        parts = [np.asarray(s[key]) for s in shards]
        if _COLUMN_PAT.search(key):
            merged[key] = np.concatenate(parts, axis=0)
        elif _ROW_PAT.search(key) or _EMBED_PAT.search(key):
            merged[key] = np.concatenate(parts, axis=1)
        else:
            merged[key] = parts[0]
    return merged


def split_consolidated_shards(
    full: Mapping[str, np.ndarray], mp_size: int
) -> list[dict[str, np.ndarray]]:
    """Split a merged state dict into mp_size shards (the split direction of
    util/tensor_parallel.py:133-161) — used by the exporter."""
    shards = [dict() for _ in range(mp_size)]
    for key, val in full.items():
        val = np.asarray(val)
        if _COLUMN_PAT.search(key):
            pieces = np.split(val, mp_size, axis=0)
        elif _ROW_PAT.search(key) or _EMBED_PAT.search(key):
            pieces = np.split(val, mp_size, axis=1)
        else:
            pieces = [val] * mp_size
        for r in range(mp_size):
            shards[r][key] = pieces[r]
    return shards


def apply_diff_checkpoint(
    base: Mapping[str, np.ndarray], diff: Mapping[str, np.ndarray]
) -> dict[str, np.ndarray]:
    """consolidated_diff semantics: diff values are (finetuned - base) deltas
    added onto the base; keys only in the diff are taken as-is
    (util/tensor_parallel.py:387-422, tools/weight_operate.py)."""
    out = dict(base)
    for k, v in diff.items():
        out[k] = (np.asarray(base[k]) + np.asarray(v)) if k in base else np.asarray(v)
    return out


def import_llama_consolidated(
    sd: Mapping[str, np.ndarray], n_layers: int, prefix: str = "llma."
) -> Params:
    """Meta/accessory-style consolidated state dict (``llma.`` prefixes,
    interleaved rotary — no permutation needed) -> our decoder params."""
    sd = _strip_prefix(sd, prefix)
    layers = []
    for i in range(n_layers):
        p = f"layers.{i}"
        layers.append(
            {
                "attention": {
                    w: {"weight": sd[f"{p}.attention.{w}.weight"].T}
                    for w in ("wq", "wk", "wv", "wo")
                },
                "feed_forward": {
                    w: {"weight": sd[f"{p}.feed_forward.{w}.weight"].T}
                    for w in ("w1", "w2", "w3")
                },
                "attention_norm": {"weight": sd[f"{p}.attention_norm.weight"]},
                "ffn_norm": {"weight": sd[f"{p}.ffn_norm.weight"]},
            }
        )
    return {
        "tok_embeddings": {"weight": sd["tok_embeddings.weight"]},
        "layers": _stack(layers),
        "norm": {"weight": sd["norm.weight"]},
        "output": {"weight": sd["output.weight"].T},
    }


def import_internlm2_hf(
    sd: Mapping[str, np.ndarray], n_layers: int, n_heads: int,
    n_kv_heads: int,
) -> Params:
    """HF InternLM2ForCausalLM -> our llama-structured decoder params.

    InternLM2 fuses qkv as grouped ``wqkv`` with layout
    [kv_heads, q_per_kv + 2, head_dim, hidden] where the first q_per_kv rows
    of each group are query heads, then one key and one value head. Rotary is
    HF half-split, so q/k get the interleave permutation after unfusing."""
    q_per_kv = n_heads // n_kv_heads
    layers = []
    for i in range(n_layers):
        p = f"model.layers.{i}"
        wqkv = sd[f"{p}.attention.wqkv.weight"]  # [(2+q)*kv*hd, hidden]
        hidden = wqkv.shape[1]
        hd = wqkv.shape[0] // (n_kv_heads * (q_per_kv + 2))
        grouped = wqkv.reshape(n_kv_heads, q_per_kv + 2, hd, hidden)
        wq = grouped[:, :q_per_kv].reshape(n_heads * hd, hidden)
        wk = grouped[:, -2].reshape(n_kv_heads * hd, hidden)
        wv = grouped[:, -1].reshape(n_kv_heads * hd, hidden)
        layers.append(
            {
                "attention": {
                    "wq": {"weight": _hf_rope_unpermute(wq.T, n_heads)},
                    "wk": {"weight": _hf_rope_unpermute(wk.T, n_kv_heads)},
                    "wv": {"weight": wv.T},
                    "wo": {"weight": sd[f"{p}.attention.wo.weight"].T},
                },
                "feed_forward": {
                    "w1": {"weight": sd[f"{p}.feed_forward.w1.weight"].T},
                    "w2": {"weight": sd[f"{p}.feed_forward.w2.weight"].T},
                    "w3": {"weight": sd[f"{p}.feed_forward.w3.weight"].T},
                },
                "attention_norm": {
                    "weight": sd[f"{p}.attention_norm.weight"]
                },
                "ffn_norm": {"weight": sd[f"{p}.ffn_norm.weight"]},
            }
        )
    return {
        "tok_embeddings": {"weight": sd["model.tok_embeddings.weight"]},
        "layers": _stack(layers),
        "norm": {"weight": sd["model.norm.weight"]},
        "output": {"weight": sd["output.weight"].T},
    }


FORMAT_FILENAME_PATTERNS = {
    "meta_ori": re.compile(r"^consolidated\.(\d{2})\.pth$"),
    "consolidated": re.compile(r"^consolidated\.(\d{2})-of-(\d{2})\.model\.pth$"),
    "diff": re.compile(r"^consolidated\.(\d{2})-of-(\d{2})\.model-diff\.pth$"),
}


def infer_checkpoint_format(path: str) -> tuple[str, int]:
    """Autodetect checkpoint format + MP size from filenames
    (util/tensor_parallel.py:333-384)."""
    import os

    files = [
        f for f in os.listdir(path) if os.path.isfile(os.path.join(path, f))
    ]
    found = None
    for fmt, pattern in FORMAT_FILENAME_PATTERNS.items():
        matched = [f for f in files if pattern.match(f)]
        if matched:
            if found is not None:
                raise NotImplementedError(
                    f"multiple checkpoint formats in {path}: {found[0]}, {fmt}"
                )
            found = (fmt, len(matched), sorted(matched))
    if found is None:
        raise FileNotFoundError(f"no recognized checkpoint files in {path}")
    return found[0], found[1]


def load_consolidated_dir(path: str) -> tuple[dict[str, np.ndarray], str]:
    """Load + merge all TP shards of a checkpoint dir (any of the three
    formats). Returns (merged numpy state dict, format)."""
    import os

    import torch

    fmt, mp_size = infer_checkpoint_format(path)
    pattern = FORMAT_FILENAME_PATTERNS[fmt]
    files = sorted(
        f
        for f in os.listdir(path)
        if os.path.isfile(os.path.join(path, f)) and pattern.match(f)
    )
    shards = []
    for f in files:
        sd = torch.load(
            os.path.join(path, f), map_location="cpu", weights_only=True
        )
        if "model" in sd and isinstance(sd["model"], dict):
            sd = sd["model"]
        shards.append(
            {k: np.asarray(v.float().numpy()) for k, v in sd.items()}
        )
    merged = merge_consolidated_shards(shards) if len(shards) > 1 else shards[0]
    return merged, fmt


def _strip_prefix(sd: Mapping[str, np.ndarray], prefix: str):
    if not any(k.startswith(prefix) for k in sd):
        return dict(sd)
    return {
        (k[len(prefix):] if k.startswith(prefix) else k): v for k, v in sd.items()
    }
