"""ConvNeXt tower (counterpart of a3vlm_tpu/models/convnext.py).
Activations stay NHWC at the boundaries; each conv runs on a
channels-last NCHW view, and conv kernels are OIHW (the bridge turns the
JAX tree's HWIO)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from a3vlm_tpu_torch.config import ConvNeXtConfig
from a3vlm_tpu_torch.models._init import trunc_normal
from a3vlm_tpu_torch.ops.norms import layer_norm
from a3vlm_tpu_torch.ops.quant_matmul import w8a8_matmul
from a3vlm_tpu_torch.quant import QuantizedWeight


def init_convnext_params(cfg: ConvNeXtConfig, dtype: torch.dtype,
                         device: torch.device | str,
                         generator: torch.Generator) -> dict:
    """Random weights shaped as convnext.py:39 makes them."""

    def tn(*shape):
        return trunc_normal(shape, dtype, device, generator)

    def zeros(n):
        return torch.zeros(n, dtype=dtype, device=device)

    def conv(out_c, in_c, k):
        return {"kernel": tn(out_c, in_c, k, k), "bias": zeros(out_c)}

    def ln(dim):
        return {"weight": torch.ones(dim, dtype=dtype, device=device),
                "bias": zeros(dim)}

    def block(dim):
        return {
            "dwconv": conv(dim, 1, 7),
            "norm": ln(dim),
            "pw1": {"weight": tn(dim, 4 * dim), "bias": zeros(4 * dim)},
            "pw2": {"weight": tn(4 * dim, dim), "bias": zeros(dim)},
            "gamma": torch.full((dim,), 1e-6, dtype=dtype, device=device),
        }

    stages = []
    for si, (depth, dim) in enumerate(zip(cfg.depths, cfg.dims)):
        stage = {"blocks": [block(dim) for _ in range(depth)]}
        if si > 0:
            stage["downsample"] = {"norm": ln(cfg.dims[si - 1]),
                                   "conv": conv(dim, cfg.dims[si - 1], 2)}
        stages.append(stage)
    p = {"stem": {"conv": conv(cfg.dims[0], 3, 4), "norm": ln(cfg.dims[0])},
         "stages": stages}
    if cfg.head_norm:
        p["head_norm"] = ln(cfg.dims[-1])
    return p


def _conv2d(x, p, stride: int, groups: int = 1, pad: int = 0):
    """NHWC conv with an OIHW kernel (convnext.py:90)."""
    out = F.conv2d(x.permute(0, 3, 1, 2), p["kernel"].to(x.dtype),
                   stride=stride, padding=pad, groups=groups)
    return out.permute(0, 2, 3, 1) + p["bias"].to(x.dtype)


def _lin(x, p):
    """Pointwise linear (convnext.py:103): dense, or the W8A8 path when
    tower-quantized; the convs (leaves named ``kernel``) stay dense."""
    w = p["weight"]
    out = w8a8_matmul(x, w) if isinstance(w, QuantizedWeight) else x @ w
    return out + p["bias"]


def _block_fwd(x, bp, eps: float):
    h = _conv2d(x, bp["dwconv"], stride=1, groups=x.shape[-1], pad=3)
    h = layer_norm(h, bp["norm"]["weight"], bp["norm"]["bias"], eps)
    h = _lin(h, bp["pw1"])
    h = F.gelu(h)
    h = _lin(h, bp["pw2"])
    return x + h * bp["gamma"]


def convnext_forward(params: dict, cfg: ConvNeXtConfig,
                     pixels: torch.Tensor) -> torch.Tensor:
    """pixels [B, H, W, 3] -> [B, H/32, W/32, dims[-1]] (convnext.py:127)."""
    x = _conv2d(pixels, params["stem"]["conv"], stride=4)
    x = layer_norm(x, params["stem"]["norm"]["weight"],
                   params["stem"]["norm"]["bias"], cfg.norm_eps)
    for si, stage in enumerate(params["stages"]):
        if si > 0:
            ds = stage["downsample"]
            x = layer_norm(x, ds["norm"]["weight"], ds["norm"]["bias"],
                           cfg.norm_eps)
            x = _conv2d(x, ds["conv"], stride=2)
        for bp in stage["blocks"]:
            x = _block_fwd(x, bp, cfg.norm_eps)
    if cfg.head_norm and "head_norm" in params:
        x = layer_norm(x, params["head_norm"]["weight"],
                       params["head_norm"]["bias"], cfg.norm_eps)
    return x
