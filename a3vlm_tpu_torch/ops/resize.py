"""Image resize with the semantics of ``jax.image.resize`` (antialiased
scale-and-translate), which the JAX package uses for the 5-crop split, the
ConvNeXt input and the DINOv2 position table. torch's ``interpolate`` uses
other cubic coefficients and edge rules, so the weights are built here as
JAX builds them: a Keys cubic (a = -0.5) or triangle kernel, widened by the
scale when downsampling, normalized per output sample, and applied as one
matrix product per spatial dim."""

from __future__ import annotations

import torch


def _keys_cubic(x: torch.Tensor) -> torch.Tensor:
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _triangle(x: torch.Tensor) -> torch.Tensor:
    return torch.clamp(1.0 - x.abs(), min=0.0)


_KERNELS = {"bicubic": _keys_cubic, "cubic": _keys_cubic,
            "bilinear": _triangle, "linear": _triangle}


def weight_matrix(in_size: int, out_size: int, method: str,
                  device: torch.device | str) -> torch.Tensor:
    """[in_size, out_size] float32 resampling weights."""
    inv_scale = in_size / out_size
    kernel_scale = max(inv_scale, 1.0)
    sample = ((torch.arange(out_size, dtype=torch.float32, device=device)
               + 0.5) * inv_scale - 0.5)
    src = torch.arange(in_size, dtype=torch.float32, device=device)
    w = _KERNELS[method]((sample[None, :] - src[:, None]).abs()
                         / kernel_scale)
    total = w.sum(0, keepdim=True)
    eps = 1000.0 * torch.finfo(torch.float32).eps
    w = torch.where(total.abs() > eps,
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w))


def resize(x: torch.Tensor, out_hw: tuple[int, int],
           method: str) -> torch.Tensor:
    """Resize the two spatial dims of channels-last ``x`` [..., H, W, C]
    in float32; returns float32."""
    H, W = x.shape[-3], x.shape[-2]
    out = x.float()
    if out_hw[0] != H:
        wh = weight_matrix(H, out_hw[0], method, x.device)
        out = torch.einsum("...hwc,hH->...Hwc", out, wh)
    if out_hw[1] != W:
        ww = weight_matrix(W, out_hw[1], method, x.device)
        out = torch.einsum("...hwc,wW->...hWc", out, ww)
    return out
