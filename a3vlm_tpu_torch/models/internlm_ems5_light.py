"""The released "7B" A3VLM, ``llama_type="internlm_ems5_light"``
(counterpart of a3vlm_tpu/models/internlm_ems5_light.py): an InternLM2-7B
decoder with only the ConvNeXt-XXL and DINOv2 towers, 1024 px inputs and
two crop scales.

- DINOv2 crops: the image resized to 224, then the four 224 quadrants of
  the image resized to 448;
- ConvNeXt crops: the image resized to 512, then the four 512 quadrants of
  the raw image: a 16x16 map plus its mean, 257 tokens, no upsampling;
- the ensemble (3072 + 1536 = 4608) goes through ``visual_proj`` (a
  Linear and a LayerNorm) to the decoder width;
- image words (257 + 2) x 5 = 1295.

InternLM2's block is LLaMA's (RMSNorm, grouped-query attention, rotary,
SwiGLU; rope theta 1e6), so the decoder is ``models/llama.py`` with 8 kv
heads. Every resize is ``ops/resize.py``'s, which antialiases a
downsample as ``jax.image.resize`` does."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

from a3vlm_tpu_torch.config import (
    CONVNEXT_XXLARGE,
    DINOV2_VIT_G14,
    ConvNeXtConfig,
    ModelArgs,
    ViTConfig,
)
from a3vlm_tpu_torch.models import convnext as cnx
from a3vlm_tpu_torch.models import ens5, llama, vit
from a3vlm_tpu_torch.models._init import trunc_normal
from a3vlm_tpu_torch.ops.norms import layer_norm
from a3vlm_tpu_torch.ops.resize import resize
from a3vlm_tpu_torch.quant import tree_map
from a3vlm_tpu_torch.utils import trace

INTERNLM2_7B = ModelArgs(
    dim=4096, n_layers=32, n_heads=32, n_kv_heads=8, vocab_size=92544,
    multiple_of=256, ffn_dim_multiplier=1.3126,  # -> ffn_hidden_dim 14336
    norm_eps=1e-5, rope_theta=1e6, max_seq_len=4096,
)


@dataclass(frozen=True)
class InternlmEns5Config:
    """internlm_ems5_light.py:39."""

    llama: ModelArgs = INTERNLM2_7B
    convnext: ConvNeXtConfig = CONVNEXT_XXLARGE
    dinov2: ViTConfig = DINOV2_VIT_G14
    image_size: int = 1024
    dino_crop: int = 224
    convnext_crop: int = 512

    @property
    def ens_dim(self) -> int:
        return self.convnext.dims[-1] + self.dinov2.width

    @property
    def tokens_per_crop(self) -> int:
        grid = self.dino_crop // self.dinov2.patch_size
        return (grid * grid + 1) + 2

    @property
    def image_words(self) -> int:
        return self.tokens_per_crop * 5


def tiny_config(vocab_size: int = 128) -> InternlmEns5Config:
    """Scaled-down config for tests (internlm_ems5_light.py:62)."""
    return InternlmEns5Config(
        llama=ModelArgs(
            dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
            vocab_size=vocab_size, multiple_of=16, max_seq_len=512,
        ),
        convnext=ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64)),
        dinov2=ViTConfig(
            image_size=28, patch_size=7, width=40, layers=2, heads=4,
            mlp_dim=64, use_swiglu=True, layer_scale=True, pos_grid_size=4,
        ),
        image_size=128,
        dino_crop=28,
        # ConvNeXt's stride 32: a 128 crop gives the 4x4 map of the dino grid
        convnext_crop=128,
    )


def init_params(cfg: InternlmEns5Config, dtype: torch.dtype,
                device: torch.device | str,
                generator: torch.Generator) -> dict:
    """Random weights shaped as internlm_ems5_light.py:80 makes them
    (values come from ``generator``, not from JAX's keys)."""
    D = cfg.llama.dim

    def tag():
        return torch.rand((1, 1, D), generator=generator,
                          device=device).to(dtype)

    return {
        "llama": llama.init_llama_params(cfg.llama, dtype, device, generator),
        "convnext": cnx.init_convnext_params(cfg.convnext, dtype, device,
                                             generator),
        "dinov2": vit.init_vit_params(cfg.dinov2, dtype, device, generator),
        "visual_proj": {
            "linear": {"weight": trunc_normal((cfg.ens_dim, D), dtype, device,
                                              generator),
                       "bias": torch.zeros(D, dtype=dtype, device=device)},
            "ln": {"weight": torch.ones(D, dtype=dtype, device=device),
                   "bias": torch.zeros(D, dtype=dtype, device=device)},
        },
        "start_img": tag(),
        "end_img": tag(),
    }


FROZEN_PREFIXES = ("convnext", "dinov2")


def trainable_mask(params: dict) -> dict:
    """True = trainable (internlm_ems5_light.py:108): the towers frozen."""
    return {k: tree_map(lambda _: k not in FROZEN_PREFIXES, v)
            for k, v in params.items()}


def _two_scale_crops(image: torch.Tensor, cfg: InternlmEns5Config):
    """(dino crops [5B, c, c, 3], ConvNeXt crops [5B, C, C, 3]) in the
    reference's per-image interleaved order: image b's five crops are rows
    5b..5b+4 (internlm_ems5_light.py:115)."""
    B = image.shape[0]

    def down(img, s):
        return resize(img, (s, s), "bicubic").to(img.dtype)

    c = cfg.dino_crop
    img_2c = down(image, 2 * c)
    parts_c = [img_2c[:, :c, :c], img_2c[:, :c, c:], img_2c[:, c:, :c],
               img_2c[:, c:, c:]]
    dino = torch.stack([down(image, c)] + parts_c, dim=1).reshape(
        5 * B, c, c, 3)

    C = cfg.convnext_crop
    half = cfg.image_size // 2
    parts_C = [image[:, :half, :half], image[:, :half, half:],
               image[:, half:, :half], image[:, half:, half:]]
    if half != C:
        parts_C = [down(p, C) for p in parts_C]
    cn = torch.stack([down(image, C)] + parts_C, dim=1).reshape(
        5 * B, C, C, 3)
    return dino, cn


@torch.no_grad()
def encode_image_features(params: dict, cfg: InternlmEns5Config,
                          image: torch.Tensor, impl: str = "auto"
                          ) -> torch.Tensor:
    """Towers only: image [B, 1024, 1024, 3] CLIP-normalized -> the
    ensemble [5B, 257, 4608], per-image interleaved. The towers are frozen
    and run without recording a gradient (the JAX ``stop_gradient``)."""
    dev = image.device
    with trace.span("towers.crops", device=dev):
        dino_in, cn_in = _two_scale_crops(image, cfg)

    with trace.span("towers.convnext", device=dev):
        cn = cnx.convnext_forward(params["convnext"], cfg.convnext, cn_in)
        cn = cn.reshape(cn.shape[0], -1, cn.shape[-1])
        cn = torch.cat([cn.mean(dim=1, keepdim=True), cn], dim=1)

    def const(vals):
        return torch.tensor(vals, device=image.device).to(image.dtype)

    with trace.span("towers.dinov2", device=dev):
        clip_mean, clip_std = const(ens5.CLIP_MEAN), const(ens5.CLIP_STD)
        d_mean, d_std = const(ens5.DINOV2_MEAN), const(ens5.DINOV2_STD)
        dino_in = dino_in * (clip_std / d_std) + (clip_mean - d_mean) / d_std
        dino = vit.vit_forward(params["dinov2"], cfg.dinov2, dino_in, impl)
    return torch.cat([cn, dino], dim=-1)


def encode_image(params: dict, cfg: InternlmEns5Config, image: torch.Tensor,
                 impl: str = "auto") -> list[torch.Tensor]:
    """image [B, 1024, 1024, 3] -> 5 x [B, 257, D]
    (internlm_ems5_light.py:148)."""
    B = image.shape[0]
    ens = encode_image_features(params, cfg, image, impl)
    p = params["visual_proj"]
    ens = ens @ p["linear"]["weight"] + p["linear"]["bias"]
    ens = layer_norm(ens, p["ln"]["weight"], p["ln"]["bias"], eps=1e-5)
    ens = ens.reshape(B, 5, *ens.shape[1:])
    return [ens[:, i] for i in range(5)]


def build_image_tokens(params: dict, cfg: InternlmEns5Config,
                       image: torch.Tensor, impl: str = "auto"
                       ) -> torch.Tensor:
    """Each crop between the start and end tags -> [B, 1295, D]
    (internlm_ems5_light.py:174)."""
    crops = encode_image(params, cfg, image, impl)
    B = image.shape[0]
    start = params["start_img"].expand(B, 1, cfg.llama.dim)
    end = params["end_img"].expand(B, 1, cfg.llama.dim)
    tokens = torch.cat(
        [t for c in crops for t in (start, c.to(start.dtype), end)], dim=1)
    if tokens.shape[1] != cfg.image_words:
        raise ValueError(f"{tokens.shape[1]} image tokens, want "
                         f"{cfg.image_words}")
    return tokens


def forward(params: dict, cfg: InternlmEns5Config, examples: torch.Tensor,
            image: Optional[torch.Tensor] = None, remat: bool = False,
            impl: str = "auto") -> torch.Tensor:
    """Training forward (internlm_ems5_light.py:190): logits of the text
    positions. The towers take ``impl`` only as "plain" or "auto"."""
    image_tokens = None
    if image is not None:
        image_tokens = build_image_tokens(
            params, cfg, image, "plain" if impl == "plain" else "auto")
    return llama.forward_train(params["llama"], cfg.llama, examples,
                               image_tokens=image_tokens, remat=remat,
                               impl=impl)


def prefill(params: dict, cfg: InternlmEns5Config, cache: llama.KVCache,
            tokens: torch.Tensor, image: Optional[torch.Tensor] = None,
            image_tokens: Optional[torch.Tensor] = None, impl: str = "auto"):
    """Inference prefill (internlm_ems5_light.py:204). Pass ``image`` to
    run the towers, or their output as ``image_tokens``."""
    if image is not None:
        image_tokens = build_image_tokens(params, cfg, image, impl)
    return llama.prefill(params["llama"], cfg.llama, cache, tokens,
                         image_tokens=image_tokens, impl=impl)


def decode_step(params: dict, cfg: InternlmEns5Config, cache: llama.KVCache,
                token: torch.Tensor, seq_pos: int, impl: str = "auto"):
    """One decode step (internlm_ems5_light.py:214)."""
    return llama.decode_step(params["llama"], cfg.llama, cache, token,
                             seq_pos, impl=impl)
