"""Model configurations of the port: ``ModelArgs`` and its JSON loader
(counterparts of a3vlm_tpu/config.py) and the tower config dataclasses
(counterparts of those in a3vlm_tpu/models/{vit,qformer,convnext,ens5}.py).
The port keeps its own copy of each."""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Optional, Sequence

__all__ = [
    "ModelArgs", "load_config_union", "model_args_from_json",
    "probe_pretrained_dir", "ViTConfig", "QFormerConfig", "ConvNeXtConfig",
    "Ens5Config", "CLIP_VIT_L14", "BLIP2_VIT_G14", "DINOV2_VIT_G14",
    "BLIP2_QFORMER", "CONVNEXT_XXLARGE", "tiny_ens5_config",
]


@dataclass(frozen=True)
class ModelArgs:
    """Decoder hyper-params; defaults are LLaMA-2-13B like the reference
    (llama_ens5.py:34-50)."""

    dim: int = 5120
    n_layers: int = 40
    n_heads: int = 40
    n_kv_heads: Optional[int] = None
    vocab_size: int = -1  # set from the tokenizer
    multiple_of: int = 256
    ffn_dim_multiplier: Optional[float] = None
    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_batch_size: int = 32
    max_seq_len: int = 2048
    rope_scaling: Optional[float] = None
    load_pretrained_visual_encoder: bool = False

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_heads if self.n_kv_heads is None else self.n_kv_heads

    @property
    def ffn_hidden_dim(self) -> int:
        """SwiGLU hidden size (llama_ens5.py:195-200)."""
        hidden = int(2 * (4 * self.dim) / 3)
        if self.ffn_dim_multiplier is not None:
            hidden = int(self.ffn_dim_multiplier * hidden)
        return self.multiple_of * ((hidden + self.multiple_of - 1) // self.multiple_of)

    def replace(self, **kw) -> "ModelArgs":
        return dataclasses.replace(self, **kw)


def load_config_union(paths: Sequence[str | Path]) -> dict[str, Any]:
    """Union of JSON config files, later files win (meta.py:34-40)."""
    merged: dict[str, Any] = {}
    for p in paths:
        with open(p) as f:
            merged.update(json.load(f))
    return merged


def model_args_from_json(
    paths: Sequence[str | Path], **overrides
) -> ModelArgs:
    cfg = load_config_union(paths)
    cfg.update(overrides)
    fields = {f.name for f in dataclasses.fields(ModelArgs)}
    return ModelArgs(**{k: v for k, v in cfg.items() if k in fields})


def probe_pretrained_dir(path: str | Path) -> dict[str, Any]:
    """Probe a checkpoint dir for meta.json / config.json like
    meta.py:164-194. Returns {"llama_type": ..., "llama_config": {...}}."""
    path = Path(path)
    out: dict[str, Any] = {}
    meta = path / "meta.json"
    if meta.exists():
        with open(meta) as f:
            out["llama_type"] = json.load(f).get("llama_type")
    cfg = path / "config.json"
    if cfg.exists():
        with open(cfg) as f:
            out["llama_config"] = json.load(f)
    return out


@dataclass(frozen=True)
class ViTConfig:
    """vit.py:35."""

    image_size: int = 224
    patch_size: int = 14
    width: int = 1024
    layers: int = 24
    heads: int = 16
    mlp_dim: int = 4096
    act: str = "gelu"  # "gelu" | "quick_gelu"
    ln_pre: bool = False
    ln_post: bool = True
    use_swiglu: bool = False
    layer_scale: bool = False
    patch_bias: bool = True
    pos_grid_size: Optional[int] = None
    norm_eps: float = 1e-6
    # route encoder attention through the hand-written kernel
    # (ops/vit_attention.py) when its inputs qualify
    attn_kernel: bool = True

    @property
    def grid(self) -> int:
        return self.image_size // self.patch_size

    @property
    def head_dim(self) -> int:
        return self.width // self.heads


CLIP_VIT_L14 = ViTConfig(
    width=1024, layers=24, heads=16, mlp_dim=4096, act="quick_gelu",
    ln_pre=True, ln_post=True, patch_bias=False, norm_eps=1e-5,
)
BLIP2_VIT_G14 = ViTConfig(
    width=1408, layers=39, heads=16, mlp_dim=6144, act="gelu",
    ln_pre=False, ln_post=True, norm_eps=1e-6,
)
DINOV2_VIT_G14 = ViTConfig(
    width=1536, layers=40, heads=24, mlp_dim=4096, act="gelu",
    ln_pre=False, ln_post=True, use_swiglu=True, layer_scale=True,
    pos_grid_size=37, norm_eps=1e-6,
)


@dataclass(frozen=True)
class QFormerConfig:
    """qformer.py:30."""

    hidden: int = 768
    layers: int = 12
    heads: int = 12
    intermediate: int = 3072
    num_queries: int = 32
    cross_attention_frequency: int = 2
    encoder_width: int = 1408
    norm_eps: float = 1e-12

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads


BLIP2_QFORMER = QFormerConfig()


@dataclass(frozen=True)
class ConvNeXtConfig:
    """convnext.py:27."""

    depths: tuple[int, ...] = (3, 4, 30, 3)
    dims: tuple[int, ...] = (384, 768, 1536, 3072)
    norm_eps: float = 1e-6
    head_norm: bool = True


CONVNEXT_XXLARGE = ConvNeXtConfig()


@dataclass(frozen=True)
class Ens5Config:
    """ens5.py:46-70. The JAX config's ``crop_shard_axes`` is not a
    field: under a mesh the crops split over every rank, its default
    ("data", "model") (models/ens5.py)."""

    llama: ModelArgs = field(default_factory=ModelArgs)
    clip: ViTConfig = CLIP_VIT_L14
    blip2_vision: ViTConfig = BLIP2_VIT_G14
    qformer: QFormerConfig = BLIP2_QFORMER
    convnext: ConvNeXtConfig = CONVNEXT_XXLARGE
    dinov2: ViTConfig = DINOV2_VIT_G14
    image_size: int = 448
    crop_size: int = 224
    convnext_size: int = 256

    @property
    def ens_dim(self) -> int:
        return self.clip.width + self.convnext.dims[-1] + self.dinov2.width

    @property
    def tokens_per_crop(self) -> int:
        grid = self.crop_size // self.clip.patch_size
        return self.qformer.num_queries + (grid * grid + 1) + 2

    @property
    def image_words(self) -> int:
        return self.tokens_per_crop * 5


def tiny_ens5_config(vocab_size: int = 128) -> Ens5Config:
    """Scaled-down config for tests (ens5.py:73)."""
    return Ens5Config(
        llama=ModelArgs(
            dim=64, n_layers=2, n_heads=4, n_kv_heads=4,
            vocab_size=vocab_size, multiple_of=16, max_seq_len=512,
            max_batch_size=4,
        ),
        clip=ViTConfig(
            image_size=28, patch_size=7, width=32, layers=2, heads=4,
            mlp_dim=64, act="quick_gelu", ln_pre=True, patch_bias=False,
        ),
        blip2_vision=ViTConfig(
            image_size=28, patch_size=7, width=48, layers=2, heads=4,
            mlp_dim=96, act="gelu",
        ),
        qformer=QFormerConfig(
            hidden=32, layers=2, heads=4, intermediate=64, num_queries=8,
            encoder_width=48,
        ),
        convnext=ConvNeXtConfig(depths=(1, 1, 1, 1), dims=(8, 16, 32, 64)),
        dinov2=ViTConfig(
            image_size=28, patch_size=7, width=40, layers=2, heads=4,
            mlp_dim=64, use_swiglu=True, layer_scale=True, pos_grid_size=4,
        ),
        image_size=56,
        crop_size=28,
        convnext_size=64,
    )
