"""Plain float32 building blocks of the references: norms, causal
grouped-query attention, rotary embeddings and the antialiased resize.
No kernel, cache or batching of the program; TF32 is switched off while
a reference runs (``float32_exact``)."""

from __future__ import annotations

import contextlib

import torch
import torch.nn.functional as F


@contextlib.contextmanager
def float32_exact():
    """float32 products in float32: no TF32 in matmuls or convolutions."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        with torch.inference_mode():
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c
        torch.set_float32_matmul_precision(prec)


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w.float()


def layer_norm(x, p, eps):
    return F.layer_norm(x, (x.shape[-1],), p["weight"].float(),
                        p["bias"].float(), eps)


def rope_angles(n: int, head_dim: int, theta: float, device):
    """cos, sin [n, head_dim / 2] of positions 0..n-1."""
    inv = 1.0 / theta ** (torch.arange(0, head_dim, 2, dtype=torch.float64,
                                       device=device) / head_dim)
    ang = torch.arange(n, dtype=torch.float64, device=device)[:, None] * inv
    return torch.cos(ang).float(), torch.sin(ang).float()


def rope_pairs(x, cos, sin):
    """LLaMA's rotary: adjacent (even, odd) pairs; x [S, H, D]."""
    e, o = x[..., 0::2], x[..., 1::2]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.stack([e * c - o * s, e * s + o * c], -1).flatten(-2)


def rope_halves(x, cos, sin):
    """Falcon's rotary: x[i] with x[i + D/2]; x [S, H, D]."""
    d2 = x.shape[-1] // 2
    a, b = x[..., :d2], x[..., d2:]
    c, s = cos[:, None, :], sin[:, None, :]
    return torch.cat([a * c - b * s, a * s + b * c], -1)


def causal_attention(q, k, v):
    """q [S, H, D], k / v [S, Hkv, D]; query head h reads kv head
    h // (H / Hkv). Returns [S, H * D]."""
    S, H, D = q.shape
    rep = H // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) * D ** -0.5
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    out = torch.einsum("hqk,khd->qhd", scores.softmax(-1), v)
    return out.reshape(S, H * D)


def full_attention(q, k, v):
    """q, k, v [B, S, H, D] -> [B, S, H * D], no mask."""
    B, S, H, D = q.shape
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * D ** -0.5
    out = torch.einsum("bhqk,bkhd->bqhd", scores.softmax(-1), v)
    return out.reshape(B, S, H * D)


def _resize_weights(n_in: int, n_out: int, device) -> torch.Tensor:
    """[n_in, n_out] weights of an antialiased Keys-cubic (a = -0.5)
    resize, ``jax.image.resize(..., "bicubic")``: the kernel widened by
    the scale when shrinking, normalised per output sample."""
    inv = n_in / n_out
    width = max(inv, 1.0)
    sample = (torch.arange(n_out, dtype=torch.float64, device=device)
              + 0.5) * inv - 0.5
    x = (sample[None, :] - torch.arange(n_in, dtype=torch.float64,
                                        device=device)[:, None]).abs() / width
    w = torch.where(x < 1, (1.5 * x - 2.5) * x * x + 1,
                    torch.where(x < 2, ((-0.5 * x + 2.5) * x - 4) * x + 2,
                                torch.zeros_like(x)))
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000 * torch.finfo(torch.float32).eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).float()


def resize(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Channels-last x [..., H, W, C] to [..., h, w, C], float32."""
    x = x.float()
    if x.shape[-3] != h:
        x = torch.einsum("...hwc,hH->...Hwc", x,
                         _resize_weights(x.shape[-3], h, x.device))
    if x.shape[-2] != w:
        x = torch.einsum("...hwc,wW->...hWc", x,
                         _resize_weights(x.shape[-2], w, x.device))
    return x
