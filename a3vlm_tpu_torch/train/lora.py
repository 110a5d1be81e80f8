"""LoRA adapters for the decoder (counterpart of a3vlm_tpu/train/lora.py):
``out = W x + B(A x)``, A trunc-normal(0.02), B zeros, no extra scaling.

The adapters are a tree of their own, ``{"layers": [per-layer {group:
{name: {"a": [in, r], "b": [r, out]}}}]}``, the decode layout of the
JAX package's stacked ``[L, in, r]`` / ``[L, r, out]`` tree; ``attach_lora``
wraps each targeted base weight in a ``LoraWeight`` for the forward, and
``merge_lora`` folds ``W + A @ B`` into dense base weights."""

from __future__ import annotations

import torch

from a3vlm_tpu_torch.models._init import trunc_normal
from a3vlm_tpu_torch.quant import LoraWeight, QuantizedWeight, tree_map

DEFAULT_TARGETS = ("wq", "wk", "wv", "wo", "w1", "w2", "w3")
GROUPS = ("attention", "feed_forward")


def _weight_geometry(w) -> tuple[int, int]:
    """(in, out) of a base weight: a packed int4 base's adapter spans its
    original input dim and the output dim of its packed ints; an int8
    base has the dense weight's shape (lora.py:56-68)."""
    if isinstance(w, QuantizedWeight):
        in_dim = w.in_dim if w.bits == 4 else w.q.shape[-2]
        return in_dim, w.q.shape[-1]
    return w.shape[-2], w.shape[-1]


def init_lora_params(generator: torch.Generator, llama_params: dict,
                     rank: int = 16, targets: tuple[str, ...] = DEFAULT_TARGETS,
                     dtype: torch.dtype = torch.float32) -> dict:
    """Adapters for every targeted linear of every layer (lora.py:26), made
    on the base weights' device from ``generator``."""
    layers = []
    for lp in llama_params["layers"]:
        layer: dict = {}
        for group in GROUPS:
            for name, wp in lp[group].items():
                if name not in targets:
                    continue
                w = wp["weight"]
                in_dim, out_dim = _weight_geometry(w)
                device = (w.q if isinstance(w, QuantizedWeight) else w).device
                layer.setdefault(group, {})[name] = {
                    "a": trunc_normal((in_dim, rank), dtype, device,
                                      generator),
                    "b": torch.zeros((rank, out_dim), dtype=dtype,
                                     device=device),
                }
        layers.append(layer)
    return {"layers": layers}


def attach_lora(llama_params: dict, lora: dict) -> dict:
    """A new decoder tree whose targeted ``weight`` leaves are
    ``LoraWeight(w, a, b)`` (lora.py:71); the input tree is unchanged."""
    layers = []
    for lp, ab_layer in zip(llama_params["layers"], lora["layers"]):
        lp = dict(lp)
        for group, items in ab_layer.items():
            lp[group] = dict(lp[group])
            for name, ab in items.items():
                lp[group][name] = {"weight": LoraWeight(
                    lp[group][name]["weight"], ab["a"], ab["b"])}
        layers.append(lp)
    return {**llama_params, "layers": layers}


def attach_lora_into_model(params: dict, lora: dict,
                           llama_key: str = "llama") -> dict:
    """For wrapped models (ens5): attach into the decoder subtree."""
    return {**params, llama_key: attach_lora(params[llama_key], lora)}


def fit_lora_to(decoder_params: dict, lora_tree: dict) -> dict:
    """Adapters sliced to the geometry of the given decoder's weights
    (lora.py:99): adapters trained against a padded base may carry rows
    or columns a dense serving base lacks."""
    layers = []
    for lp, ab_layer in zip(decoder_params["layers"], lora_tree["layers"]):
        layer: dict = {}
        for group, items in ab_layer.items():
            for name, ab in items.items():
                in_dim, out_dim = _weight_geometry(lp[group][name]["weight"])
                layer.setdefault(group, {})[name] = {
                    "a": ab["a"][:in_dim, :], "b": ab["b"][:, :out_dim]}
        layers.append(layer)
    return {"layers": layers}


# the row-parallel linears: their adapters split ``a`` on its input
ROW_PARALLEL = ("wo", "w2")


def lora_partition_specs(lora: dict) -> dict:
    """Specs of the adapters on a mesh (lora.py:135), per layer: a
    column-parallel weight's ``b`` split on its output over "model" and
    ``a`` replicated; a row-parallel weight's (wo, w2) ``a`` split on its
    input and ``b`` replicated."""
    from a3vlm_tpu_torch.parallel.mesh import MODEL_AXIS, P

    col = {"a": P(None, None), "b": P(None, MODEL_AXIS)}
    row = {"a": P(MODEL_AXIS, None), "b": P(None, None)}
    return {"layers": [
        {group: {name: (row if name in ROW_PARALLEL else col)
                 for name in items}
         for group, items in layer.items()}
        for layer in lora["layers"]]}


def merge_lora(llama_params: dict, lora: dict) -> dict:
    """A new decoder tree whose targeted weights are ``W + A @ B``, the
    product and the sum in the weight's dtype (lora.py:149); the input
    tree is unchanged. A packed base cannot take the sum."""
    layers = []
    for lp, ab_layer in zip(llama_params["layers"], lora["layers"]):
        lp = dict(lp)
        for group, items in ab_layer.items():
            lp[group] = dict(lp[group])
            for name, ab in items.items():
                w = lp[group][name]["weight"]
                if isinstance(w, QuantizedWeight):
                    raise ValueError("merge_lora needs a dense base: serve "
                                     "adapters on a packed base unmerged "
                                     "(MetaModel.load_lora)")
                delta = ab["a"].to(w.dtype) @ ab["b"].to(w.dtype)
                lp[group][name] = {"weight": w + delta}
        layers.append(lp)
    return {**llama_params, "layers": layers}


def merge_lora_into_model(params: dict, lora: dict,
                          llama_key: str = "llama") -> dict:
    """For wrapped models (ens5): merge into the decoder subtree."""
    return {**params, llama_key: merge_lora(params[llama_key], lora)}


def lora_base_trainable_mask(decoder_params: dict) -> dict:
    """Decoder trainability under LoRA (lora.py:116): only leaves on a path
    through a norm, an ``ln*`` scope or named ``bias`` train; linear
    weights, packed bases, embeddings and the head freeze."""

    def walk(node, names):
        if isinstance(node, dict):
            return {k: walk(v, names + [k]) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, names) for v in node]
        return tree_map(lambda _: (
            "norm" in "/".join(names)
            or (bool(names) and names[-1] == "bias")
            or any(n.startswith("ln") for n in names)), node)

    return walk(decoder_params, [])
