"""The RGB + depth A3VLM, ``llama_type="llama_ens5_2images"`` (counterpart
of a3vlm_tpu/models/ens5_2images.py): both images go through the same ens5
towers; the sequence is [BOS | RGB tokens between the image tags | depth
tokens between the depth tags | text], so image words = 1455 x 2 = 2910.
Inference needs both images."""

from __future__ import annotations

from typing import Optional

import torch

from a3vlm_tpu_torch.config import Ens5Config, tiny_ens5_config
from a3vlm_tpu_torch.models import ens5, llama

tiny_config = tiny_ens5_config
trainable_mask = ens5.trainable_mask
quant_blocklist = ens5.quant_blocklist
decode_step = ens5.decode_step


def init_params(cfg: Ens5Config, dtype: torch.dtype,
                device: torch.device | str,
                generator: torch.Generator) -> dict:
    """ens5's weights, then the two learned depth tags from the same
    generator (ens5_2images.py:24)."""
    params = ens5.init_ens5_params(cfg, dtype, device, generator)
    for tag in ("start_depth_img", "end_depth_img"):
        params[tag] = torch.rand((1, 1, cfg.llama.dim), generator=generator,
                                 device=device).to(dtype)
    return params


def image_words(cfg: Ens5Config) -> int:
    return cfg.image_words * 2


def build_image_tokens(params: dict, cfg: Ens5Config,
                       image: Optional[torch.Tensor] = None,
                       depth_image: Optional[torch.Tensor] = None,
                       impl: str = "auto",
                       image_features: Optional[dict] = None,
                       depth_features: Optional[dict] = None
                       ) -> torch.Tensor:
    """[B, 2 x 1455, D]: the RGB crops between the image tags, then the
    depth crops between the depth tags (ens5_2images.py:38). Each stream
    takes its raw image or its ``encode_image_features`` output."""
    D = cfg.llama.dim

    def tagged(img, feats, start, end):
        if feats is None:
            feats = ens5.encode_image_features(params, cfg, img, impl)
        elif img is not None:
            raise ValueError("pass image OR features per stream")
        crops = ens5.project_image_features(params, cfg, feats)
        B = crops[0].shape[0]
        s, e = start.expand(B, 1, D), end.expand(B, 1, D)
        return torch.cat([t for c in crops for t in (s, c.to(s.dtype), e)],
                         dim=1)

    rgb = tagged(image, image_features, params["start_img"],
                 params["end_img"])
    dep = tagged(depth_image, depth_features, params["start_depth_img"],
                 params["end_depth_img"])
    return torch.cat([rgb, dep], dim=1)


def forward(params: dict, cfg: Ens5Config, examples: torch.Tensor,
            image: Optional[torch.Tensor] = None,
            depth_image: Optional[torch.Tensor] = None, remat: bool = False,
            impl: str = "auto", image_features: Optional[dict] = None,
            depth_features: Optional[dict] = None) -> torch.Tensor:
    """Training forward (ens5_2images.py:77): with images, both streams are
    required. The towers take ``impl`` only as "plain" or "auto"."""
    image_tokens = None
    if any(x is not None for x in (image, image_features, depth_image,
                                   depth_features)):
        if (image is None) == (image_features is None):
            raise ValueError("2-image model needs the rgb stream (image or "
                             "features)")
        if (depth_image is None) == (depth_features is None):
            raise ValueError("2-image model needs the depth stream (image "
                             "or features)")
        image_tokens = build_image_tokens(
            params, cfg, image, depth_image,
            "plain" if impl == "plain" else "auto",
            image_features=image_features, depth_features=depth_features)
    return llama.forward_train(params["llama"], cfg.llama, examples,
                               image_tokens=image_tokens, remat=remat,
                               impl=impl)


def prefill(params: dict, cfg: Ens5Config, cache: llama.KVCache,
            tokens: torch.Tensor, image: Optional[torch.Tensor] = None,
            depth_image: Optional[torch.Tensor] = None,
            image_tokens: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Inference prefill (ens5_2images.py:107). Pass both images to run the
    towers, or their output as ``image_tokens``."""
    if image is not None:
        if depth_image is None:
            raise ValueError("llama_ens5_2images requires depth images")
        image_tokens = build_image_tokens(params, cfg, image, depth_image,
                                          impl)
    return llama.prefill(params["llama"], cfg.llama, cache, tokens,
                         image_tokens=image_tokens, impl=impl)
