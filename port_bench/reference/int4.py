"""The int4 weight format the configurations state, worked out by the
reference from the dense weights: symmetric groups along the input dim,
scale = absmax / 7 in the weight's dtype, codes round(w / scale) taken in
that dtype and clipped to [-7, 7]; an input dim of 1024 or more is
zero-padded (to a multiple of 1024, or of 4096 where that adds at most
1/8), and the group is 64, halved until it divides the padded dim and
its half. Returns the dense float32 weight the codes stand for."""

from __future__ import annotations

import torch

GROUP = 64


def geometry(K: int) -> tuple[int, int]:
    pad = K
    if K >= 1024:
        pad = -(-K // 1024) * 1024
        pad4096 = -(-K // 4096) * 4096
        if pad4096 <= 1.125 * K:
            pad = max(pad, pad4096)
    g = min(GROUP, pad)
    while pad % g or (pad // 2) % g:
        g //= 2
    return pad, g


def dequantized(w: torch.Tensor, cols: int = 8192) -> torch.Tensor:
    """float32 [K, N] of the int4 codes of ``w`` [K, N] times their scales,
    ``cols`` output columns at a time."""
    K, N = w.shape
    if K % 2:
        raise ValueError("int4 needs an even input dim")
    pad, g = geometry(K)
    out = torch.empty((K, N), dtype=torch.float32, device=w.device)
    for c in range(0, N, cols):
        wf = w[:, c:c + cols].float()
        if pad != K:
            wf = torch.cat([wf, wf.new_zeros(pad - K, wf.shape[1])])
        wg = wf.view(pad // g, g, -1)
        amax = wg.abs().amax(dim=1, keepdim=True)
        amax = torch.maximum(amax, torch.tensor(1e-8).to(w.dtype).float()
                             .to(w.device))
        scale = (amax / 7.0).to(w.dtype).float()
        q = torch.round((wg / scale).to(w.dtype).float()).clamp(-7, 7)
        out[:, c:c + cols] = (q * scale).view(pad, -1)[:K]
    return out
