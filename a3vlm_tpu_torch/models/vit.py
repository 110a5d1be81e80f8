"""Vision Transformer for the CLIP, EVA and DINOv2 towers (counterpart of
a3vlm_tpu/models/vit.py). Parameters are the JAX tree as tensors: blocks
stacked on a leading layer axis, linear weights [in, out], the patch
conv OIHW. Pixels are NHWC."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from a3vlm_tpu_torch.config import ViTConfig
from a3vlm_tpu_torch.models._init import trunc_normal
from a3vlm_tpu_torch.ops.attention import attention
from a3vlm_tpu_torch.ops.norms import layer_norm
from a3vlm_tpu_torch.ops.quant_matmul import w8a8_matmul
from a3vlm_tpu_torch.ops.resize import resize
from a3vlm_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_eligible,
)
from a3vlm_tpu_torch.quant import QuantizedWeight


def init_vit_params(cfg: ViTConfig, dtype: torch.dtype,
                    device: torch.device | str,
                    generator: torch.Generator) -> dict:
    """Random tower weights shaped as vit.py:91 makes them."""
    W, L, M = cfg.width, cfg.layers, cfg.mlp_dim
    grid = cfg.pos_grid_size or cfg.grid
    mlp_in = 2 * M if cfg.use_swiglu else M

    def tn(*shape):
        return trunc_normal(shape, dtype, device, generator)

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    def ones(*shape):
        return torch.ones(shape, dtype=dtype, device=device)

    p = {
        "patch_embed": {
            "kernel": tn(W, 3, cfg.patch_size, cfg.patch_size),
            "bias": zeros(W) if cfg.patch_bias else None,
        },
        "class_embedding": tn(W),
        "positional_embedding": tn(grid * grid + 1, W),
        "blocks": {
            "ln1": {"weight": ones(L, W), "bias": zeros(L, W)},
            "attn": {
                "wqkv": {"weight": tn(L, W, 3 * W), "bias": zeros(L, 3 * W)},
                "wo": {"weight": tn(L, W, W), "bias": zeros(L, W)},
            },
            "ln2": {"weight": ones(L, W), "bias": zeros(L, W)},
            "mlp": {
                "fc1": {"weight": tn(L, W, mlp_in), "bias": zeros(L, mlp_in)},
                "fc2": {"weight": tn(L, M, W), "bias": zeros(L, W)},
            },
        },
    }
    if cfg.layer_scale:
        p["blocks"]["ls1"] = torch.full((L, W), 1e-5, dtype=dtype,
                                        device=device)
        p["blocks"]["ls2"] = torch.full((L, W), 1e-5, dtype=dtype,
                                        device=device)
    if cfg.ln_pre:
        p["ln_pre"] = {"weight": ones(W), "bias": zeros(W)}
    if cfg.ln_post:
        p["ln_post"] = {"weight": ones(W), "bias": zeros(W)}
    return p


def interpolate_pos_embed(pos: torch.Tensor, src_grid: int,
                          dst_grid: int) -> torch.Tensor:
    """Bicubic resize of the patch rows of the position table, class row
    kept (vit.py:135)."""
    if src_grid == dst_grid:
        return pos
    W = pos.shape[-1]
    patch = pos[1:].reshape(src_grid, src_grid, W)
    patch = resize(patch, (dst_grid, dst_grid), "bicubic").to(pos.dtype)
    return torch.cat([pos[:1], patch.reshape(-1, W)], dim=0)


def _lin(x, p):
    """Tower linear (vit.py:151): dense ``x @ w + b``, or the W8A8 path
    when the weight was tower-quantized (``ens5.quantize_tower_params``)."""
    w = p["weight"]
    out = w8a8_matmul(x, w) if isinstance(w, QuantizedWeight) else x @ w
    return out + p["bias"]


def _act(x, kind: str):
    if kind == "quick_gelu":
        return x * torch.sigmoid(1.702 * x)
    return F.gelu(x)


def _vit_block(h, lp, cfg: ViTConfig, impl: str):
    B, S, W = h.shape
    x = layer_norm(h, lp["ln1"]["weight"], lp["ln1"]["bias"], cfg.norm_eps)
    q, k, v = _lin(x, lp["attn"]["wqkv"]).split(W, dim=-1)
    shape = (B, S, cfg.heads, cfg.head_dim)
    q, k, v = q.reshape(shape), k.reshape(shape), v.reshape(shape)
    if impl == "auto" and cfg.attn_kernel and vit_attention_eligible(q):
        out = vit_attention(q, k, v)
    else:
        out = attention(q, k, v, mask=None, impl="plain")
    out = _lin(out.reshape(B, S, W), lp["attn"]["wo"])
    if cfg.layer_scale:
        out = out * lp["ls1"]
    h = h + out
    x = layer_norm(h, lp["ln2"]["weight"], lp["ln2"]["bias"], cfg.norm_eps)
    x = _lin(x, lp["mlp"]["fc1"])
    if cfg.use_swiglu:
        gate, up = x.chunk(2, dim=-1)
        x = F.silu(gate) * up
    else:
        x = _act(x, cfg.act)
    x = _lin(x, lp["mlp"]["fc2"])
    if cfg.layer_scale:
        x = x * lp["ls2"]
    return h + x


def vit_forward(params: dict, cfg: ViTConfig, pixels: torch.Tensor,
                impl: str = "auto") -> torch.Tensor:
    """pixels [B, H, W, 3] -> all token features [B, 1 + grid^2, width]
    after ln_post (vit.py:205)."""
    B, H = pixels.shape[0], pixels.shape[1]
    grid = H // cfg.patch_size
    pe = params["patch_embed"]
    x = F.conv2d(pixels.to(pe["kernel"].dtype).permute(0, 3, 1, 2),
                 pe["kernel"], stride=cfg.patch_size)  # [B, W, g, g]
    x = x.permute(0, 2, 3, 1)
    if pe["bias"] is not None:
        x = x + pe["bias"]
    x = x.reshape(B, grid * grid, cfg.width)
    cls = params["class_embedding"][None, None, :].expand(B, 1, cfg.width)
    x = torch.cat([cls.to(x.dtype), x], dim=1)
    pos = interpolate_pos_embed(params["positional_embedding"],
                                cfg.pos_grid_size or cfg.grid, grid)
    x = x + pos[None].to(x.dtype)
    if cfg.ln_pre:
        x = layer_norm(x, params["ln_pre"]["weight"], params["ln_pre"]["bias"],
                       cfg.norm_eps)
    blocks = params["blocks"]
    for i in range(cfg.layers):
        lp = _layer(blocks, i)
        x = _vit_block(x, lp, cfg, impl)
    if cfg.ln_post:
        x = layer_norm(x, params["ln_post"]["weight"],
                       params["ln_post"]["bias"], cfg.norm_eps)
    return x


def _layer(stacked: dict, i: int) -> dict:
    def pick(v):
        if isinstance(v, dict):
            return _layer(v, i)
        return v.layer(i) if isinstance(v, QuantizedWeight) else v[i]

    return {k: pick(v) for k, v in stacked.items()}
