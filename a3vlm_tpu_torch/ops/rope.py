"""Rotary position embeddings, Meta-interleaved pairs (counterpart of
a3vlm_tpu/ops/rope.py)."""

from __future__ import annotations

import torch


def precompute_freqs_cis(dim: int, end: int, theta: float = 10000.0,
                         scaling: float | None = None, *,
                         device: torch.device | str) -> torch.Tensor:
    """``[end, dim//2, 2]`` float32 table of (cos, sin); ``scaling`` is
    linear position interpolation (rope.py:17)."""
    exponent = torch.arange(0, dim, 2, dtype=torch.float32,
                            device=device)[: dim // 2] / dim
    inv_freq = 1.0 / (theta ** exponent)
    t = torch.arange(end, dtype=torch.float32, device=device)
    if scaling is not None:
        t = t / float(scaling)
    freqs = torch.outer(t, inv_freq)
    return torch.stack([torch.cos(freqs), torch.sin(freqs)], dim=-1)


def apply_rotary_emb(xq: torch.Tensor, xk: torch.Tensor,
                     freqs_cis: torch.Tensor):
    """Rotate ``xq`` [B, S, Hq, D] and ``xk`` [B, S, Hk, D] by
    ``freqs_cis`` [S, D//2, 2], or [B, S, D//2, 2] for per-row positions,
    in float32, as adjacent (even, odd) pairs, and cast back
    (rope.py:40-70)."""
    if freqs_cis.dim() == 4:
        cos = freqs_cis[..., 0][:, :, None, :]
        sin = freqs_cis[..., 1][:, :, None, :]
    else:
        cos = freqs_cis[..., 0][None, :, None, :]
        sin = freqs_cis[..., 1][None, :, None, :]

    def rot(x):
        xf = x.float()
        even, odd = xf[..., 0::2], xf[..., 1::2]
        out = torch.stack([even * cos - odd * sin, even * sin + odd * cos],
                          dim=-1)
        return out.reshape(x.shape).to(x.dtype)

    return rot(xq), rot(xk)
