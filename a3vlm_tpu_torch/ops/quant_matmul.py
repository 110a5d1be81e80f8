"""Quantized matmuls and the quantized-linear dispatcher (counterpart of
a3vlm_tpu/ops/quant_matmul.py; kernels in csrc/int4_matmul.cu,
csrc/int8_matmul.cu and csrc/int4_matmul_a8.cu).

Every kernel has a wrapper and a plain PyTorch version beside it. A wrapper
launches its kernel on CUDA tensors (a split-K GEMV for M <= 32, a
tensor-core tiled product above) or raises; CPU tensors take the plain
version, as does ``impl="plain"`` on any device.

Wrappers (each ``name`` has its ``name_plain``) and what they compute:

- ``int4_matmul_2d`` (``variant="v1"``): ``x @ dequant(W4)``, each weight
  scaled, then rounded to x's dtype;
- ``int4_matmul_2d_v3``: the same product, the group scale applied to each
  group's float32 partial instead;
- ``int4_matmul_2d_glu``: ``res + (silu(g) * u) @ dequant(W4)``;
- ``int4_matmul_2d_w4a8``: per-row int8 activations, int32 group dots;
- ``int4_matmul_2d_w8a8p``: int8 activations against the weights
  requantized to int8 per column;
- ``int8_matmul_2d``: ``(x @ W8) * scale``.

The mode flags below are module attributes, as in the JAX package. PyTorch
runs eagerly, so a flag set here takes effect at the next call (the JAX
flags are read when a function is traced). The JAX module's tile knobs
(``block``, ``bm``, ``PREFILL_BM``, ``W8A8P_BM``) have no counterpart.
"""

from __future__ import annotations

import functools
import os

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
_GEMV_KS = 128  # rows per split of every GEMV: GV_KS, G8_KS, GA_KS in csrc

# what variant="auto" means (quant_matmul.py:41): "v1" or "v3"
_AUTO_VARIANT = os.environ.get("A3VLM_INT4_VARIANT", "v1")

# W4A8 decode (quant_matmul.py:64): int4 matmuls with M <= W4A8_MAX_M
# quantize the activations per row to int8 and contract in integers. Not
# exact against the bf16 kernels (the activations round to 8 bits): opt-in.
W4A8_DECODE = False
W4A8_MAX_M = 32

# W8A8 prefill (quant_matmul.py:76): int4 matmuls with
# M >= W8A8_PREFILL_MIN_M requantize the weights to int8 per column inside
# the kernel and contract int8 x int8 over the whole K. Not exact: opt-in.
W8A8_PREFILL = False
W8A8_PREFILL_MIN_M = 256

_W8A8P_LEVELS = 15.875  # 127 / 8: |q4| <= 8 times a ratio <= 15.875


def _dequant_2d(q, scale, group: int, dtype):
    """Packed q [Kpad/2, N] -> [Kpad, N] in ``dtype``: float32 nibble times
    group scale, rounded once."""
    half, N = q.shape
    lo, hi = unpack_int4(q)
    w = torch.cat([lo, hi], dim=0).reshape(2 * half // group, group, N)
    return (w.float() * scale[:, None, :]).reshape(2 * half, N).to(dtype)


def _group_dots(xf, q, scale, group: int):
    """float32 [M, N] = sum over groups of scale[g] * (xf[:, Kg] @ q4[Kg]),
    each group's product on the unscaled nibbles. ``xf`` [M, Kpad] float32
    (bf16 values or int8 values, exact either way). Groups are taken a few
    at a time so the [groups, M, N] partials stay under 1 GiB."""
    M, kpad = xf.shape
    half, N = q.shape
    G = kpad // group
    lo, hi = unpack_int4(q)
    w = torch.cat([lo, hi], dim=0).reshape(G, group, N)
    xg = xf.reshape(M, G, group).transpose(0, 1)  # [G, M, group]
    out = torch.zeros((M, N), dtype=torch.float32, device=xf.device)
    step = max(1, 2 ** 28 // max(M * N, 1))
    for g0 in range(0, G, step):
        part = torch.bmm(xg[g0:g0 + step], w[g0:g0 + step].float())
        out += (part * scale[g0:g0 + step, None, :]).sum(dim=0)
    return out


def _int_dot(a, b):
    """Exact int8 [M, K] @ int8 [K, N] -> int32. On the card one library
    call where it takes the shape; else float32 products over chunks of
    1024 rows of K, whose sums (<= 127 * 127 * 1024 < 2^24) are exact in
    float32 in any order. Used by the plain versions and by
    ``w8a8_matmul``, never by a kernel's wrapper."""
    M, K = a.shape
    N = b.shape[1]
    if a.is_cuda and M > 16 and K % 8 == 0 and N % 8 == 0:
        return torch._int_mm(a.contiguous(), b.contiguous())
    out = torch.zeros((M, N), dtype=torch.int32, device=a.device)
    for k0 in range(0, K, 1024):
        out += (a[:, k0:k0 + 1024].float()
                @ b[k0:k0 + 1024].float()).to(torch.int32)
    return out


def quantize_act_int8(x):
    """Per-row symmetric int8 of the activations (quant_matmul.py:399):
    [M, K] -> (int8 [M, K], float32 [M, 1] scale = max(absmax, 1e-8) / 127),
    round half to even. The divisor is a tensor: a Python divisor on a CUDA
    tensor becomes a product with its rounded reciprocal."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    s = m / torch.full_like(m, 127.0)
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q, s


def w8a8p_factors(scale):
    """(r, cs) of the W8A8 prefill math (quant_matmul.py:311-313): the
    requantization ratios ``scale * (15.875 / smax)`` [Kpad/group, N] and
    the column scales ``smax / 15.875`` [1, N], in this float32
    association (another one rounds some half-step weights the other way)."""
    smax = scale.amax(dim=0, keepdim=True).clamp_min(1e-30)
    levels = torch.full_like(smax, _W8A8P_LEVELS)
    return (scale * (levels / smax)).float(), (smax / levels).float()


def requantize_w8(q, ratio, group: int):
    """Packed int4 q [Kpad/2, N] -> int8 [Kpad, N]:
    ``round(q4 * ratio[g])``, round half to even; |w8| <= 127, no clip."""
    half, N = q.shape
    lo, hi = unpack_int4(q)
    q4 = torch.cat([lo, hi], dim=0).reshape(2 * half // group, group, N)
    w8 = torch.round(q4.float() * ratio[:, None, :])
    return w8.to(torch.int8).reshape(2 * half, N)


# ------------------------------------------------------- plain versions
def int4_matmul_2d_plain(x, q, scale, group: int):
    """x [M, Kpad] @ packed q [Kpad/2, N] -> [M, N] in x's dtype: both
    halves dequantized to x's dtype (float32 nibble times group scale) and
    stacked into the [Kpad, N] weight, then one product, so the two halves
    share one accumulation and one rounding, as in the kernel."""
    return x @ _dequant_2d(q, scale, group, x.dtype)


def int4_matmul_2d_v3_plain(x, q, scale, group: int):
    """The v3 math (quant_matmul.py:147): per-group products on unscaled
    nibbles in float32, the group scale on each float32 partial."""
    return _group_dots(x.float(), q, scale, group).to(x.dtype)


def int4_matmul_2d_glu_plain(g, u, q, scale, res, group: int):
    """``res + (silu(g) * u) @ W`` as the fused kernel forms it
    (quant_matmul.py:105): silu in float32 as ``sigmoid(g) * g * u``,
    rounded to g's dtype before the product; the product summed in float32,
    the residual added in float32, one rounding at the end."""
    gf = g.float()
    z = (torch.sigmoid(gf) * gf * u.float()).to(g.dtype)
    acc = z.float() @ _dequant_2d(q, scale, group, g.dtype).float()
    return (acc + res.float()).to(res.dtype)


def int4_matmul_2d_w4a8_plain(x, q, scale, group: int):
    """The W4A8 math (``_int4_w4a8_xla``, quant_matmul.py:467): per-row int8
    activations, exact integer dots per group (in float32: |sum| <=
    127 * 8 * group), scaled per group, then by the row scale."""
    xq, xs = quantize_act_int8(x)
    return (_group_dots(xq.float(), q, scale, group) * xs).to(x.dtype)


def int4_matmul_2d_w8a8p_plain(x, q, scale, group: int):
    """The W8A8 prefill math (``_int4_w8a8p_xla``, quant_matmul.py:364):
    int8 activations against the weights requantized to int8 per column,
    an exact int32 sum over the whole K, then
    ``float(acc) * xs * cs`` in that order."""
    xq, xs = quantize_act_int8(x)
    ratio, cs = w8a8p_factors(scale)
    acc = _int_dot(xq, requantize_w8(q, ratio, group))
    return (acc.float() * xs * cs).to(x.dtype)


def int8_matmul_2d_plain(x, q, scale):
    """x [M, K] @ int8 q [K, N], scale [1, N] -> [M, N] in x's dtype, as
    the kernel sums it (quant_matmul.py:993): the unscaled product in
    float32 (int8 is exact there), the scale on the finished sum, one
    rounding."""
    return ((x.float() @ q.float()) * scale.reshape(1, -1)).to(x.dtype)


# -------------------------------------------------------------- wrappers
def _require_int4(name, x, q, scale, group):
    M, kpad = x.shape
    half, N = q.shape
    _kernels.require(kpad == 2 * half, f"{name}: x {tuple(x.shape)} vs "
                     f"q {tuple(q.shape)}")
    _kernels.require(half % group == 0 and scale.shape == (kpad // group, N),
                     f"{name}: scale shape")
    _kernels.require(N % 16 == 0, f"{name}: N must be a multiple of 16")
    _kernels.require_cuda(name, q, dtype=torch.int8)
    _kernels.require_cuda(name, scale, dtype=torch.float32)
    return M, half, N


def _splitk_scratch(rows: int, M: int, N: int, device):
    return torch.empty((-(-rows // _GEMV_KS), M, N), dtype=torch.float32,
                       device=device)


def _launch_int4(name: str, mode: str, x, q, scale, group: int, u=None,
                 res=None):
    """Launch the int4 kernel in ``mode`` "v1", "v3" or "glu" (x is then
    g); returns (out, error code)."""
    M, half, N = _require_int4(name, x, q, scale, group)
    _kernels.require_cuda(name, x, dtype=torch.bfloat16)
    if mode == "glu":
        _kernels.require(u.shape == x.shape and res.shape == (M, N),
                         f"{name}: u {tuple(u.shape)}, res {tuple(res.shape)}")
        _kernels.require_cuda(name, u, res, dtype=torch.bfloat16)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _kernels.lib()
    p = torch.Tensor.data_ptr
    tail = (M, half, N, group, _kernels.stream())
    if M <= GEMV_MAX_M:
        partial = _splitk_scratch(half, M, N, x.device)
        if mode == "glu":
            err = lib.a3_int4_gemv_glu(p(x), p(u), p(q), p(scale), p(res),
                                       p(partial), p(out), *tail)
        else:
            fn = lib.a3_int4_gemv if mode == "v1" else lib.a3_int4_gemv_v3
            err = fn(p(x), p(q), p(scale), p(partial), p(out), *tail)
        return out, err
    _kernels.require(half % 32 == 0, f"{name}: K/2 must be a multiple of 32 "
                     "for M > 32")
    if mode == "glu":
        err = lib.a3_int4_mma_glu(p(x), p(u), p(q), p(scale), p(res), p(out),
                                  *tail)
    elif mode == "v3":
        _kernels.require(group % 32 == 0, f"{name}: group must be a "
                         "multiple of 32 for M > 32")
        err = lib.a3_int4_mma_v3(p(x), p(q), p(scale), p(out), *tail)
    else:
        err = lib.a3_int4_mma(p(x), p(q), p(scale), p(out), *tail)
    return out, err


def int4_matmul_2d_v3(x, q, scale, group: int):
    """Wrapper of the v3 int4 kernel (quant_matmul.py:496 with
    ``variant="v3"``); operands as ``int4_matmul_2d``."""
    if x.device.type == "cpu":
        return int4_matmul_2d_v3_plain(x, q, scale, group)
    out, err = _launch_int4("int4_matmul_v3", "v3", x, q, scale, group)
    int4_matmul_2d_v3.launches += 1
    _kernels.check(err, "a3_int4_matmul_v3")
    return out


int4_matmul_2d_v3.launches = 0


def int4_matmul_2d(x, q, scale, group: int, variant: str = "auto"):
    """Wrapper of the int4 kernel (quant_matmul.py:496). x [M, Kpad] bf16,
    q [Kpad/2, N] int8, scale [Kpad/group, N] float32, all contiguous;
    N % 16 == 0; for M > 32 also Kpad/2 % 32 == 0. Returns [M, N] bf16.
    ``variant``: "v1", "v3" (``int4_matmul_2d_v3``, which keeps its own
    launch count), or "auto" = ``_AUTO_VARIANT``."""
    if variant == "auto":
        variant = _AUTO_VARIANT
    if variant == "v3":
        return int4_matmul_2d_v3(x, q, scale, group)
    if variant != "v1":
        raise ValueError(f"int4_matmul: variant {variant!r}")
    if x.device.type == "cpu":
        return int4_matmul_2d_plain(x, q, scale, group)
    out, err = _launch_int4("int4_matmul", "v1", x, q, scale, group)
    int4_matmul_2d.launches += 1
    _kernels.check(err, "a3_int4_matmul")
    return out


int4_matmul_2d.launches = 0


def int4_matmul_2d_glu(g, u, q, scale, res, group: int):
    """Wrapper of the GLU-fused int4 kernel (quant_matmul.py:601):
    ``res + (silu(g) * u) @ W``. g, u [M, Kpad] bf16, res [M, N] bf16, the
    weight as ``int4_matmul_2d``. Returns [M, N] bf16."""
    if g.device.type == "cpu":
        return int4_matmul_2d_glu_plain(g, u, q, scale, res, group)
    out, err = _launch_int4("int4_matmul_glu", "glu", g, q, scale, group,
                            u=u, res=res)
    int4_matmul_2d_glu.launches += 1
    _kernels.check(err, "a3_int4_matmul_glu")
    return out


int4_matmul_2d_glu.launches = 0


def int4_matmul_2d_w4a8(x, q, scale, group: int):
    """Wrapper of the W4A8 kernel (quant_matmul.py:411): x [M, Kpad] bf16
    with M <= 32 is quantized per row to int8 here, in tensor ops as the
    JAX package does outside its kernel; the kernel contracts in integers.
    The weight as ``int4_matmul_2d``. Returns [M, N] bf16."""
    if x.device.type == "cpu":
        return int4_matmul_2d_w4a8_plain(x, q, scale, group)
    M, half, N = _require_int4("int4_matmul_w4a8", x, q, scale, group)
    _kernels.require(M <= GEMV_MAX_M, f"int4_matmul_w4a8: M={M} > "
                     f"{GEMV_MAX_M}")
    _kernels.require_cuda("int4_matmul_w4a8", x, dtype=torch.bfloat16)
    xq, xs = quantize_act_int8(x)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    partial = _splitk_scratch(half, M, N, x.device)
    err = _kernels.lib().a3_int4_gemv_a8(
        xq.data_ptr(), xs.data_ptr(), q.data_ptr(), scale.data_ptr(),
        partial.data_ptr(), out.data_ptr(), M, half, N, group,
        _kernels.stream())
    int4_matmul_2d_w4a8.launches += 1
    _kernels.check(err, "a3_int4_gemv_a8")
    return out


int4_matmul_2d_w4a8.launches = 0


def int4_matmul_2d_w8a8p(x, q, scale, group: int):
    """Wrapper of the W8A8 prefill kernel (quant_matmul.py:299): x [M, Kpad]
    bf16 is quantized per row to int8, and the ratios and column scales are
    formed from ``scale``, here in tensor ops per call, as the JAX package
    does; the kernel requantizes the weights and contracts int8 x int8.
    Kpad/2 % 32 == 0. Returns [M, N] bf16."""
    if x.device.type == "cpu":
        return int4_matmul_2d_w8a8p_plain(x, q, scale, group)
    M, half, N = _require_int4("int4_matmul_w8a8p", x, q, scale, group)
    _kernels.require(half % 32 == 0, "int4_matmul_w8a8p: K/2 must be a "
                     "multiple of 32")
    _kernels.require_cuda("int4_matmul_w8a8p", x, dtype=torch.bfloat16)
    xq, xs = quantize_act_int8(x)
    ratio, cs = w8a8p_factors(scale)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    err = _kernels.lib().a3_int4_mma_w8a8p(
        xq.data_ptr(), xs.data_ptr(), q.data_ptr(), ratio.data_ptr(),
        cs.data_ptr(), out.data_ptr(), M, half, N, group, _kernels.stream())
    int4_matmul_2d_w8a8p.launches += 1
    _kernels.check(err, "a3_int4_mma_w8a8p")
    return out


int4_matmul_2d_w8a8p.launches = 0


def int8_matmul_2d(x, q, scale):
    """Wrapper of the int8 kernel (quant_matmul.py:1012). x [M, K] bf16, q
    [K, N] int8, scale [1, N] (or [N]) float32, contiguous; N % 16 == 0,
    and K % 8 == 0 for M > 32. Returns [M, N] bf16."""
    if x.device.type == "cpu":
        return int8_matmul_2d_plain(x, q, scale)
    M, K = x.shape
    K2, N = q.shape
    _kernels.require(K == K2 and scale.numel() == N,
                     f"int8_matmul: x {tuple(x.shape)}, q {tuple(q.shape)}, "
                     f"scale {tuple(scale.shape)}")
    _kernels.require(N % 16 == 0, "int8_matmul: N must be a multiple of 16")
    _kernels.require_cuda("int8_matmul", x, dtype=torch.bfloat16)
    _kernels.require_cuda("int8_matmul", q, dtype=torch.int8)
    _kernels.require_cuda("int8_matmul", scale, dtype=torch.float32)
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _kernels.lib()
    if M <= GEMV_MAX_M:
        partial = _splitk_scratch(K, M, N, x.device)
        err = lib.a3_int8_gemv(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               partial.data_ptr(), out.data_ptr(), M, K, N,
                               _kernels.stream())
    else:
        _kernels.require(K % 8 == 0, "int8_matmul: K must be a multiple of "
                         "8 for M > 32")
        err = lib.a3_int8_mma(x.data_ptr(), q.data_ptr(), scale.data_ptr(),
                              out.data_ptr(), M, K, N, _kernels.stream())
    int8_matmul_2d.launches += 1
    _kernels.check(err, "a3_int8_matmul")
    return out


int8_matmul_2d.launches = 0


# ------------------------------------------------------------ dispatchers
def _pad_k(x, qw: QuantizedWeight, name: str):
    kpad = qw.q.shape[-2] * 2
    K = x.shape[-1]
    if K != qw.in_dim:
        raise ValueError(f"{name}: x has K={K}, weight {qw.in_dim}")
    if kpad != K:
        x = F.pad(x, (0, kpad - K))
    return x.reshape(-1, kpad).contiguous()


def int4_matmul(x, qw: QuantizedWeight, impl: str = "auto",
                variant: str = "auto"):
    """x [..., K] @ int4-packed weight -> [..., N] (quant_matmul.py:946):
    x is zero-padded to the packed K. With ``W8A8_PREFILL`` set, M >=
    ``W8A8_PREFILL_MIN_M`` rows take the W8A8 prefill math; with
    ``W4A8_DECODE`` set, M <= ``W4A8_MAX_M`` rows take the W4A8 math; the
    rest take the exact kernel in ``variant``. ``impl="plain"`` takes the
    same route through the plain versions, on any device. The flags are
    read at every call."""
    lead = x.shape[:-1]
    x2 = _pad_k(x, qw, "int4_matmul")
    M = x2.shape[0]
    if W8A8_PREFILL and M >= W8A8_PREFILL_MIN_M:
        fn, fn_plain = int4_matmul_2d_w8a8p, int4_matmul_2d_w8a8p_plain
    elif W4A8_DECODE and M <= W4A8_MAX_M:
        fn, fn_plain = int4_matmul_2d_w4a8, int4_matmul_2d_w4a8_plain
    elif (_AUTO_VARIANT if variant == "auto" else variant) == "v3":
        fn, fn_plain = int4_matmul_2d_v3, int4_matmul_2d_v3_plain
    else:
        fn = functools.partial(int4_matmul_2d, variant=variant)
        fn_plain = int4_matmul_2d_plain
    out = (fn_plain if impl == "plain" else fn)(x2, qw.q, qw.scale, qw.group)
    return out.reshape(*lead, out.shape[-1])


def int4_ffn_down(g, u, qw: QuantizedWeight, res, impl: str = "auto"):
    """The fused FFN tail ``res + (silu(g) * u) @ W2`` in one kernel
    (quant_matmul.py:658). g, u [..., K], res [..., N]; ``qw`` a single
    layer's int4 weight."""
    lead = g.shape[:-1]
    g2 = _pad_k(g, qw, "int4_ffn_down")
    u2 = _pad_k(u, qw, "int4_ffn_down")
    res2 = res.reshape(-1, res.shape[-1]).contiguous()
    fn = int4_matmul_2d_glu_plain if impl == "plain" else int4_matmul_2d_glu
    out = fn(g2, u2, qw.q, qw.scale, res2, qw.group)
    return out.reshape(*lead, out.shape[-1])


def int8_matmul(x, qw: QuantizedWeight, impl: str = "auto"):
    """x [..., K] @ int8 weight [K, N] with one scale per output channel
    (quant_matmul.py:1124)."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fn = int8_matmul_2d_plain if impl == "plain" else int8_matmul_2d
    out = fn(x2, qw.q, qw.scale.reshape(1, -1))
    return out.reshape(*lead, out.shape[-1])


def w8a8_matmul(x, qw: QuantizedWeight):
    """W8A8 for the frozen vision towers (quant_matmul.py:1146): per-row
    int8 activations against the per-channel int8 weight, an exact int32
    product, and the rank-1 float32 epilogue ``acc * a_scale * w_scale``.
    Plain tensor ops, as in the JAX package (no TPU kernel stands behind
    it); on the card the integer product is one library call."""
    if qw.bits != 8:
        raise ValueError("w8a8_matmul wants per-channel int8 weights")
    lead = x.shape[:-1]
    a, a_scale = quantize_act_int8(x.reshape(-1, x.shape[-1]))
    acc = _int_dot(a, qw.q)
    out = (acc.float() * a_scale * qw.scale.reshape(1, -1).float()).to(x.dtype)
    return out.reshape(*lead, out.shape[-1])


def _quant_matmul(x, qw: QuantizedWeight, impl: str):
    if qw.bits == 8:
        return int8_matmul(x, qw, impl)
    return int4_matmul(x, qw, impl)


class _QmatQuant(torch.autograd.Function):
    """Differentiable linear over a frozen quantized base
    (quant_matmul.py:1177-1206): the forward is ``int4_matmul`` or
    ``int8_matmul`` (the kernel on CUDA tensors); the backward is
    ``g @ dequant(W)^T`` in g's dtype, the product of the dense weight's
    first ``in_dim`` rows, so the gradient has x's unpadded shape. The
    quantized ints and scales get no gradient."""

    @staticmethod
    def forward(ctx, x, q, scale, bits: int, group: int, in_dim: int,
                impl: str):
        ctx.save_for_backward(q, scale)
        ctx.bits, ctx.group, ctx.in_dim = bits, group, in_dim
        return _quant_matmul(x, QuantizedWeight(q, scale, bits, group,
                                                in_dim), impl)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        w = _dequantize_leaf(QuantizedWeight(q, scale, ctx.bits, ctx.group,
                                             ctx.in_dim), g.dtype)
        return g @ w.transpose(-1, -2), None, None, None, None, None, None


def qmat(x, w, impl: str = "auto"):
    """Quantization-aware linear (quant_matmul.py:1209): ``x @ w`` for a
    dense ``w``, the differentiable int4 or int8 matmul for a
    ``QuantizedWeight``, and for a ``LoraWeight`` the base product plus
    the rank-r side path ``(x @ a) @ b`` in x's dtype."""
    if isinstance(w, LoraWeight):
        return qmat(x, w.w, impl) + (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype)
    if isinstance(w, QuantizedWeight):
        if torch.is_grad_enabled() and x.requires_grad:
            return _QmatQuant.apply(x, w.q, w.scale, w.bits, w.group,
                                    w.in_dim, impl)
        return _quant_matmul(x, w, impl)
    return x @ w
