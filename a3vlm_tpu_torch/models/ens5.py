"""The A3VLM flagship model, ``llama_type="llama_ens5"`` (counterpart of
a3vlm_tpu/models/ens5.py): LLaMA-2 decoder plus four frozen towers over a
5-crop split of each 448 px image.

Per crop: 32 Q-Former tokens and 257 ensemble tokens (CLIP 1024 ++
ConvNeXt 3072 ++ DINOv2 1536) between learned start/end tags, 291 tokens;
5 crops give 1455 image words. The sequence is [BOS | image | text].
Images are NHWC and CLIP-normalized."""

from __future__ import annotations

from typing import Optional

import torch

from a3vlm_tpu_torch.config import Ens5Config
from a3vlm_tpu_torch.models import convnext as cnx
from a3vlm_tpu_torch.models import llama, qformer, vit
from a3vlm_tpu_torch.models._init import trunc_normal
from a3vlm_tpu_torch.ops.norms import layer_norm
from a3vlm_tpu_torch.ops.resize import resize
from a3vlm_tpu_torch.quant import _quantize_leaf_int8, tree_map

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
DINOV2_MEAN = (0.485, 0.456, 0.406)
DINOV2_STD = (0.229, 0.224, 0.225)

FROZEN_PREFIXES = ("clip", "blip2_vision", "qformer", "convnext", "dinov2")


def trainable_mask(params: dict) -> dict:
    """True = trainable (ens5.py:156): the four towers are frozen; the
    projectors, image tags and decoder train."""
    return {k: tree_map(lambda _: k not in FROZEN_PREFIXES, v)
            for k, v in params.items()}


def quant_blocklist() -> tuple[str, ...]:
    """Subtrees kept dense under weight quantization (ens5.py:169)."""
    return FROZEN_PREFIXES + ("qformer_proj", "visual_proj")


# towers whose linears take the W8A8 path when quantized (vit._lin,
# convnext._lin); the Q-Former stays dense (ens5.py:175)
W8A8_TOWER_KEYS = ("clip", "blip2_vision", "dinov2", "convnext")


def quantize_tower_params(params: dict,
                          keys: tuple[str, ...] = W8A8_TOWER_KEYS) -> dict:
    """Per-output-channel int8 of the frozen vision towers, the serving
    side's W8A8 mode (ens5.py:181): matmul ``weight`` leaves of two or more
    dims outside ``norm``/``ln*`` scopes are quantized from their float32
    values; conv kernels, norms, biases, embeddings and layer scales stay
    dense. IN PLACE on the containers of ``params``, leaf by leaf, on the
    device the weights are on; returns ``params``."""

    def walk(node, names):
        items = node.items() if isinstance(node, dict) else enumerate(node)
        for key, x in list(items):
            if isinstance(x, (dict, list)):
                walk(x, names + [key] if isinstance(key, str) else names)
            elif (key == "weight" and isinstance(x, torch.Tensor)
                  and x.dim() >= 2
                  and not any("norm" in n or n.startswith("ln")
                              for n in names)):
                node[key] = _quantize_leaf_int8(x.float())

    for k in keys:
        if k in params:
            walk(params[k], [])
    return params


def init_ens5_params(cfg: Ens5Config, dtype: torch.dtype,
                     device: torch.device | str,
                     generator: torch.Generator) -> dict:
    """Random weights for the whole model, shaped as ens5.py:107 makes
    them (values come from ``generator``, not from JAX's keys)."""
    D = cfg.llama.dim

    def proj(in_dim):
        return {
            "linear": {"weight": trunc_normal((in_dim, D), dtype, device,
                                              generator),
                       "bias": torch.zeros(D, dtype=dtype, device=device)},
            "ln": {"weight": torch.ones(D, dtype=dtype, device=device),
                   "bias": torch.zeros(D, dtype=dtype, device=device)},
        }

    def tag():
        return torch.rand((1, 1, D), generator=generator,
                          device=device).to(dtype)

    return {
        "llama": llama.init_llama_params(cfg.llama, dtype, device, generator),
        "clip": vit.init_vit_params(cfg.clip, dtype, device, generator),
        "blip2_vision": vit.init_vit_params(cfg.blip2_vision, dtype, device,
                                            generator),
        "qformer": qformer.init_qformer_params(cfg.qformer, dtype, device,
                                               generator),
        "convnext": cnx.init_convnext_params(cfg.convnext, dtype, device,
                                             generator),
        "dinov2": vit.init_vit_params(cfg.dinov2, dtype, device, generator),
        "qformer_proj": proj(cfg.qformer.hidden),
        "visual_proj": proj(cfg.ens_dim),
        "start_img": tag(),
        "end_img": tag(),
    }


def _apply_proj(x, p):
    x = x @ p["linear"]["weight"] + p["linear"]["bias"]
    return layer_norm(x, p["ln"]["weight"], p["ln"]["bias"], eps=1e-5)


def five_crop(image: torch.Tensor, crop: int) -> torch.Tensor:
    """[B, 2c, 2c, 3] -> [5B, c, c, 3]: the bicubic-downsampled image, then
    the four quadrants, along the batch (ens5.py:229)."""
    down = resize(image, (crop, crop), "bicubic").to(image.dtype)
    parts = [image[:, :crop, :crop], image[:, :crop, crop:],
             image[:, crop:, :crop], image[:, crop:, crop:]]
    return torch.cat([down] + parts, dim=0)


@torch.no_grad()
def encode_image_features(params: dict, cfg: Ens5Config,
                          image: torch.Tensor, impl: str = "auto") -> dict:
    """Towers only (ens5.py:245): image [B, 448, 448, 3] -> {"q": Q-Former
    queries [5B, nq, 768], "ens": [5B, 257, 5632]}. The towers are frozen
    and run without recording a gradient (the JAX ``stop_gradient`` at
    ens5.py:289-292)."""
    crops = five_crop(image, cfg.crop_size)

    blip = vit.vit_forward(params["blip2_vision"], cfg.blip2_vision, crops,
                           impl)
    q_feats = qformer.qformer_forward(params["qformer"], cfg.qformer, blip)

    clip_feats = vit.vit_forward(params["clip"], cfg.clip, crops, impl)

    size = cfg.convnext_size
    cn_in = resize(crops, (size, size), "bilinear").to(crops.dtype)
    cn = cnx.convnext_forward(params["convnext"], cfg.convnext, cn_in)
    cn = cn.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    cn = cn.reshape(cn.shape[0], -1, cn.shape[-1])
    cn = torch.cat([cn.mean(dim=1, keepdim=True), cn], dim=1)

    def const(vals):
        return torch.tensor(vals, device=crops.device).to(crops.dtype)

    dino_in = ((crops * const(CLIP_STD) + const(CLIP_MEAN)
                - const(DINOV2_MEAN)) / const(DINOV2_STD))
    dino = vit.vit_forward(params["dinov2"], cfg.dinov2, dino_in, impl)

    ens = torch.cat([clip_feats, cn, dino], dim=-1)
    return {"q": q_feats, "ens": ens}


def project_image_features(params: dict, cfg: Ens5Config,
                           feats: dict) -> list[torch.Tensor]:
    """Projectors and the per-crop split (ens5.py:296): 5 x [B, 289, D]."""
    q_feats = _apply_proj(feats["q"], params["qformer_proj"])
    ens = _apply_proj(feats["ens"], params["visual_proj"])
    return list(torch.cat([q_feats, ens], dim=1).chunk(5, dim=0))


def build_image_tokens(params: dict, cfg: Ens5Config,
                       image: Optional[torch.Tensor] = None,
                       impl: str = "auto",
                       image_features: Optional[dict] = None) -> torch.Tensor:
    """Encode and wrap each crop in the start/end tags -> [B, image_words,
    D] (ens5.py:324). Pass ``image`` to run the towers, or their output
    (``encode_image_features``) as ``image_features``."""
    if (image is None) == (image_features is None):
        raise ValueError("pass exactly one of image and image_features")
    if image_features is None:
        image_features = encode_image_features(params, cfg, image, impl)
    crops = project_image_features(params, cfg, image_features)
    B = crops[0].shape[0]
    start = params["start_img"].expand(B, 1, cfg.llama.dim)
    end = params["end_img"].expand(B, 1, cfg.llama.dim)
    tokens = torch.cat(
        [t for c in crops for t in (start, c.to(start.dtype), end)], dim=1)
    if tokens.shape[1] != cfg.image_words:
        raise ValueError(f"{tokens.shape[1]} image tokens, want "
                         f"{cfg.image_words}")
    return tokens


def forward(params: dict, cfg: Ens5Config, examples: torch.Tensor,
            image: Optional[torch.Tensor] = None, remat: bool = False,
            impl: str = "auto",
            image_features: Optional[dict] = None) -> torch.Tensor:
    """Training forward (ens5.py:351): logits for the text positions,
    [B, S_text, V]. The towers run without gradient; the projectors and
    tags carry it. The towers take ``impl`` only as "plain" or "auto", as
    the JAX forward leaves them at their default."""
    image_tokens = None
    if image is not None or image_features is not None:
        tower_impl = "plain" if impl == "plain" else "auto"
        image_tokens = build_image_tokens(params, cfg, image, tower_impl,
                                          image_features=image_features)
    return llama.forward_train(params["llama"], cfg.llama, examples,
                               image_tokens=image_tokens, remat=remat,
                               impl=impl)


def prefill(params: dict, cfg: Ens5Config, cache: llama.KVCache,
            tokens: torch.Tensor, image: Optional[torch.Tensor] = None,
            image_tokens: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Inference prefill (ens5.py:379). Pass ``image`` to run the towers,
    or their output as ``image_tokens``."""
    if image is not None:
        image_tokens = build_image_tokens(params, cfg, image, impl)
    return llama.prefill(params["llama"], cfg.llama, cache, tokens,
                         image_tokens=image_tokens, impl=impl)


def decode_step(params: dict, cfg: Ens5Config, cache: llama.KVCache,
                token: torch.Tensor, seq_pos: int, impl: str = "auto"):
    """One decode step (ens5.py:397)."""
    return llama.decode_step(params["llama"], cfg.llama, cache, token,
                             seq_pos, impl=impl)
