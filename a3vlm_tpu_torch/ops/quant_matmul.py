"""int4 dequant-matmul and the quantized-linear dispatcher (counterpart of
a3vlm_tpu/ops/quant_matmul.py, int4 only; kernel in csrc/int4_matmul.cu).

``int4_matmul_2d`` is the kernel's wrapper: CUDA tensors launch the kernel
(a split-K GEMV for M <= 32, a tensor-core tiled product above), CPU
tensors take ``int4_matmul_2d_plain``, the two-dot math of the JAX
package's ``_int4_matmul_xla`` (quant_matmul.py:688)."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from a3vlm_tpu_torch.ops import _kernels
from a3vlm_tpu_torch.quant import (
    LoraWeight,
    QuantizedWeight,
    _dequantize_leaf,
    unpack_int4,
)

GEMV_MAX_M = 32
_GEMV_KS = 128  # packed rows per split, csrc/int4_matmul.cu GV_KS


def int4_matmul_2d_plain(x, q, scale, group: int):
    """x [M, Kpad] @ packed q [Kpad/2, N] -> [M, N] in x's dtype: both
    halves dequantized to x's dtype (float32 nibble times group scale) and
    stacked into the [Kpad, N] weight, then one product, so the two halves
    share one accumulation and one rounding, as in the kernel."""
    half, N = q.shape
    lo, hi = unpack_int4(q)
    w = torch.cat([lo, hi], dim=0).reshape(2 * half // group, group, N)
    w = (w.float() * scale[:, None, :]).reshape(2 * half, N).to(x.dtype)
    return x @ w


def int4_matmul_2d(x, q, scale, group: int):
    """Wrapper of the int4 kernel (quant_matmul.py:496). x [M, Kpad] bf16,
    q [Kpad/2, N] int8, scale [Kpad/group, N] float32, all contiguous;
    N % 16 == 0; for M > 32 also Kpad/2 % 32 == 0. Returns [M, N] bf16."""
    if x.device.type == "cpu":
        return int4_matmul_2d_plain(x, q, scale, group)
    M, kpad = x.shape
    half, N = q.shape
    _kernels.require(kpad == 2 * half, f"int4_matmul: x {tuple(x.shape)} vs "
                     f"q {tuple(q.shape)}")
    _kernels.require(half % group == 0 and scale.shape == (kpad // group, N),
                     "int4_matmul: scale shape")
    _kernels.require(N % 16 == 0, "int4_matmul: N must be a multiple of 16")
    _kernels.require_cuda("int4_matmul", x, dtype=torch.bfloat16)
    _kernels.require_cuda("int4_matmul", q, dtype=torch.int8)
    _kernels.require_cuda("int4_matmul", scale, dtype=torch.float32)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _kernels.lib()
    if M <= GEMV_MAX_M:
        splits = -(-half // _GEMV_KS)
        partial = torch.empty((splits, M, N), dtype=torch.float32,
                              device=x.device)
        err = lib.a3_int4_gemv(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), partial.data_ptr(),
            out.data_ptr(), M, half, N, group, _kernels.stream(),
        )
    else:
        _kernels.require(half % 32 == 0, "int4_matmul: K/2 must be a "
                         "multiple of 32 for M > 32")
        err = lib.a3_int4_mma(
            x.data_ptr(), q.data_ptr(), scale.data_ptr(), out.data_ptr(), M,
            half, N, group, _kernels.stream(),
        )
    int4_matmul_2d.launches += 1
    _kernels.check(err, "a3_int4_matmul")
    return out


int4_matmul_2d.launches = 0


def int4_matmul(x, qw: QuantizedWeight, impl: str = "auto"):
    """x [..., K] @ int4-packed weight -> [..., N] (quant_matmul.py:946):
    x is zero-padded to the packed K. ``impl="plain"`` takes the plain
    version on any device."""
    kpad = qw.q.shape[-2] * 2
    K = x.shape[-1]
    if K != qw.in_dim:
        raise ValueError(f"int4_matmul: x has K={K}, weight {qw.in_dim}")
    if kpad != K:
        x = F.pad(x, (0, kpad - K))
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kpad).contiguous()
    fn = int4_matmul_2d_plain if impl == "plain" else int4_matmul_2d
    out = fn(x2, qw.q, qw.scale, qw.group)
    return out.reshape(*lead, out.shape[-1])


class _QmatQuant(torch.autograd.Function):
    """Differentiable int4 linear over a frozen packed base
    (quant_matmul.py:1177-1206): the forward is ``int4_matmul`` (the kernel
    on CUDA tensors); the backward is ``g @ dequant(W)^T`` in g's dtype,
    the product of the dense weight's first ``in_dim`` rows, so the
    gradient has x's unpadded shape. The packed ints and scales get no
    gradient."""

    @staticmethod
    def forward(ctx, x, q, scale, group: int, in_dim: int, impl: str):
        ctx.save_for_backward(q, scale)
        ctx.group, ctx.in_dim = group, in_dim
        return int4_matmul(x, QuantizedWeight(q, scale, group=group,
                                              in_dim=in_dim), impl)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        w = _dequantize_leaf(QuantizedWeight(q, scale, group=ctx.group,
                                             in_dim=ctx.in_dim), g.dtype)
        return g @ w.transpose(-1, -2), None, None, None, None, None


def qmat(x, w, impl: str = "auto"):
    """Quantization-aware linear (quant_matmul.py:1209): ``x @ w`` for a
    dense ``w``, the differentiable int4 dequant-matmul for a
    ``QuantizedWeight``, and for a ``LoraWeight`` the base product plus
    the rank-r side path ``(x @ a) @ b`` in x's dtype."""
    if isinstance(w, LoraWeight):
        return qmat(x, w.w, impl) + (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
    if isinstance(w, QuantizedWeight):
        if torch.is_grad_enabled() and x.requires_grad:
            return _QmatQuant.apply(x, w.q, w.scale, w.group, w.in_dim, impl)
        return int4_matmul(x, w, impl)
    return x @ w
