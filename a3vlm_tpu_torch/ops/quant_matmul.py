"""Quantized matmuls and the quantized-linear dispatcher (counterpart of
a3vlm_tpu/ops/quant_matmul.py; kernels in csrc/int4_matmul.cu,
csrc/int8_matmul.cu and csrc/int4_matmul_a8.cu).

Every kernel has a wrapper and a plain PyTorch version beside it. A wrapper
launches its kernel on CUDA tensors (a GEMV for M <= 32, a tensor-core
tiled product above) or raises; CPU tensors take the plain version, as does
``impl="plain"`` on any device. The GEMVs of every mode (K1, K1v3, K11, the
W4A8 decode K7 and the int8 K6; csrc/gemv_cluster.cuh) are one launch with
no scratch: a thread block cluster of ``gemv_splits`` blocks splits K for
each 128 output columns, each block streams its stages of weight bytes,
scales and x by TMA into rings in shared memory and multiplies on
mma.sync from the weights converted once in registers, and the blocks add
their partials through distributed shared memory in a fixed order; they
take any group that divides K/2 (int4) and N % 16 == 0. The W4A8 wrapper
first quantizes x per row with one kernel (``quantize_act_int8``), which
the W8A8 wrappers share. The tiled products (csrc/matmul_common.cuh, and
K8's in csrc/int4_matmul_a8.cu: TMA-fed tiles, wgmma) take K/2 % 64 == 0
and group % 64 == 0 for the int4 modes (a 64-row step of K lies in one
group), K % 8 == 0 for int8, N % 16 == 0, and 16-byte aligned contiguous
operands; their wrappers raise on anything else.

The dispatchers (``int4_matmul``, ``int4_ffn_down``, ``int8_matmul``) check
that domain from the shapes alone, as the JAX dispatcher checks its
kernels' (``_kernel_eligible``, ``_int8_kernel_eligible``): on the card a
shape the mode's kernel does not take goes to the reference's route for
that mode, plain tensor ops (``INT4_FALLBACK``: the dense two-product route
of ``_int4_matmul_xla`` for v1 and v3, the W4A8 and W8A8 prefill math, the
unfused FFN tail; ``int8_matmul_dense`` for int8), and adds one to
``int4_matmul.fallbacks[mode]`` or ``int8_matmul.fallbacks`` instead of a
kernel's count. Every weight of the 13B decoder lies inside the domain.

Wrappers (each ``name`` has its ``name_plain``) and what they compute:

- ``int4_matmul_2d`` (``variant="v1"``): ``x @ dequant(W4)``, each weight
  scaled, then rounded to x's dtype;
- ``int4_matmul_2d_v3``: the same product, the group scale applied to each
  group's float32 partial instead;
- ``int4_matmul_2d_glu``: ``res + (silu(g) * u) @ dequant(W4)``;
- ``int4_matmul_2d_w4a8``: per-row int8 activations, int32 group dots;
- ``int4_matmul_2d_w8a8p``: int8 activations against the weights
  requantized to int8 per column;
- ``int8_matmul_2d``: ``(x @ W8) * scale``;
- ``quantize_act_int8``: per-row int8 activations and their scales.

The mode flags below are module attributes, as in the JAX package. PyTorch
runs eagerly, so a flag set here takes effect at the next call (the JAX
flags are read when a function is traced). The JAX module's tile knobs
(``block``, ``bm``, ``PREFILL_BM``, ``W8A8P_BM``) have no counterpart.
"""

from __future__ import annotations

import math
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
# the GEMV: output columns a block, weight rows a stage (packed rows for
# int4, rows of K for int8), blocks a cluster at most (GV_BN, GV_SR,
# GV_MAX_CLUSTER in csrc/gemv_cluster.cuh)
GEMV_BN = 128
GEMV_STAGE_ROWS = 64
GEMV_MAX_CLUSTER = 8
_GEMV_MODES = {"v1": 0, "v3": 1, "glu": 2}  # of a3_int4_gemv
_GEMV_CAPACITY: dict[tuple, tuple] = {}

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

# Dense prefill (quant_matmul.py:52): with it set, int4 matmuls with M >= it
# dequantize the weight and take two dense products, as the JAX package's
# ``_int4_matmul_xla`` does: each half's product rounds to x's dtype before
# their sum, where the kernel sums both in float32. None: off.
PREFILL_DENSE_MIN_M = None

_TILE_MIN = 64  # K rows of a tiled-route weight tile: half, group divide

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
    call at the shapes of the decoder and the towers (K and N multiples of
    32, at least 256; the library refuses some small ones, such as K 96
    against N 64); else float32 products over chunks of 1024 rows of K,
    whose sums (<= 127 * 127 * 1024 < 2^24) are exact in float32 in any
    order. Used by the plain versions and by ``w8a8_matmul``, never by a
    kernel's wrapper."""
    M, K = a.shape
    N = b.shape[1]
    if (a.is_cuda and M > 16 and K % 32 == 0 and N % 32 == 0
            and min(K, N) >= 256):
        return torch._int_mm(a.contiguous(), b.contiguous())
    out = torch.zeros((M, N), dtype=torch.int32, device=a.device)
    for k0 in range(0, K, 1024):
        out += (a[:, k0:k0 + 1024].float()
                @ b[k0:k0 + 1024].float()).to(torch.int32)
    return out


def quantize_act_int8_plain(x):
    """Per-row symmetric int8 of the activations (quant_matmul.py:399):
    [..., K] -> (int8 [..., K], float32 [..., 1] scale = max(absmax, 1e-8)
    / 127), round half to even. The divisor is a tensor: a Python divisor
    on a CUDA tensor becomes a product with its rounded reciprocal."""
    xf = x.float()
    m = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8)
    s = m / torch.full_like(m, 127.0)
    q = torch.round(xf / s).clamp(-127, 127).to(torch.int8)
    return q, s


def quantize_act_int8(x):
    """Wrapper of the row quantizer (csrc/int4_matmul_a8.cu): on a CUDA
    tensor (bf16 or float32, [..., K]) one launch, a block a row, equal to
    ``quantize_act_int8_plain`` bit for bit. Both quotients are correctly
    rounded, as the tensor ops take them: a reciprocal multiply or
    ``__fdividef`` would move some values across a rounding boundary and
    lose the bit-identity with the JAX package."""
    if x.device.type == "cpu":
        return quantize_act_int8_plain(x)
    name = "quantize_act_int8"
    lead, K = x.shape[:-1], x.shape[-1]
    x2 = x.reshape(-1, K).contiguous()
    M = x2.shape[0]
    q = torch.empty((M, K), dtype=torch.int8, device=x.device)
    s = torch.empty((M, 1), dtype=torch.float32, device=x.device)
    if M == 0 or K == 0:
        return q.reshape(*lead, K), s.reshape(*lead, 1)
    _kernels.require(x.dtype in (torch.bfloat16, torch.float32),
                     f"{name}: dtype {x.dtype}, want bfloat16 or float32")
    _kernels.require_cuda(name, x2)
    err = _kernels.lib().a3_quantize_act_int8(
        x2.data_ptr(), q.data_ptr(), s.data_ptr(), M, K,
        int(x.dtype == torch.float32), _kernels.stream())
    quantize_act_int8.launches += 1
    _kernels.check(err, "a3_quantize_act_int8")
    return q.reshape(*lead, K), s.reshape(*lead, 1)


quantize_act_int8.launches = 0


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


def int4_matmul_dense(x, q, scale, group: int):
    """The dense prefill route (``_int4_matmul_xla``, quant_matmul.py:688):
    each half of the packed weight dequantized to x's dtype (float32 nibble
    times group scale, rounded once), then two products in x's dtype,
    ``x[:, :K/2] @ lo + x[:, K/2:] @ hi``. Plain tensor ops on any device,
    as the JAX package computes it outside any kernel."""
    half = q.shape[0]
    w = _dequant_2d(q, scale, group, x.dtype)
    return x[:, :half] @ w[:half] + x[:, half:] @ w[half:]


def int4_matmul_2d_w4a8_plain(x, q, scale, group: int):
    """The W4A8 math (``_int4_w4a8_xla``, quant_matmul.py:467): per-row int8
    activations, exact integer dots per group (in float32: |sum| <=
    127 * 8 * group), scaled per group, then by the row scale."""
    xq, xs = quantize_act_int8_plain(x)
    return (_group_dots(xq.float(), q, scale, group) * xs).to(x.dtype)


def int4_matmul_2d_w8a8p_plain(x, q, scale, group: int):
    """The W8A8 prefill math (``_int4_w8a8p_xla``, quant_matmul.py:364):
    int8 activations against the weights requantized to int8 per column,
    an exact int32 sum over the whole K, then
    ``float(acc) * xs * cs`` in that order."""
    xq, xs = quantize_act_int8_plain(x)
    ratio, cs = w8a8p_factors(scale)
    acc = _int_dot(xq, requantize_w8(q, ratio, group))
    return (acc.float() * xs * cs).to(x.dtype)


def int8_matmul_dense(x, q, scale):
    """The int8 route of the JAX dispatcher for shapes its kernel does not
    take (quant_matmul.py:1133-1137): the weight dequantized to x's dtype
    (float32 times the column scale, rounded once), then one product in
    x's dtype. Plain tensor ops on any device."""
    return x @ (q.float() * scale.reshape(1, -1)).to(x.dtype)


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


def _gemv_runs(half: int, group: int) -> int:
    """Runs of whole stages that hold whole groups (the int4 GEMV never
    splits one between blocks): stages of lcm(64, group) rows."""
    stage_rows = GEMV_STAGE_ROWS * group // math.gcd(GEMV_STAGE_ROWS, group)
    return -(-half // stage_rows)


def gemv_splits(N: int, half: int, group: int, capacity) -> int:
    """Blocks of the int4 GEMV's cluster, which split K for each 128 output
    columns: the most, up to 8, for which the card holds a cluster for
    every column tile at once (``capacity[C - 1]``: clusters of C blocks
    resident together, which share a GPC), no more than there are runs of
    whole groups of stages, and none left without a run. More leave a
    second wave; fewer leave SMs idle."""
    tiles = -(-N // GEMV_BN)
    runs = _gemv_runs(half, group)
    for C in range(min(GEMV_MAX_CLUSTER, runs), 1, -1):
        if capacity[C - 1] >= tiles and -(-runs // C) * (C - 1) < runs:
            return C
    return 1


def _gemv_capacity(lib, device, mode: str, M: int, group: int) -> tuple:
    """Clusters of 1-8 blocks of the GEMV in ``mode`` ("v1", "v3", "glu",
    "w4a8" or "int8") for M rows (a kernel per 8 rows) and this group's
    scale rows a stage that the card holds at once, per card (``device``
    an index)."""
    key = (device, mode, -(-M // 8), group)
    if key not in _GEMV_CAPACITY:
        caps = []
        for C in range(1, GEMV_MAX_CLUSTER + 1):
            if mode == "w4a8":
                n = lib.a3_int4_gemv_a8_clusters(M, group, C)
            elif mode == "int8":
                n = lib.a3_int8_gemv_clusters(M, C)
            else:
                n = lib.a3_int4_gemv_clusters(_GEMV_MODES[mode], M, group, C)
            _kernels.check(0 if n > 0 else -n, "gemv clusters")
            caps.append(n)
        _GEMV_CAPACITY[key] = tuple(caps)
    return _GEMV_CAPACITY[key]


def _gemv_rows(x, half: int, align: int = 8):
    """x [M, 2 half] as the GEMV reads it: its two halves ``xld`` elements
    apart, xld % align == 0 (the tensor map's strides are multiples of 16
    bytes: 8 bf16, 16 int8). Returns (tensor, xld): x itself, or a
    zero-padded copy where half % align != 0."""
    if half % align == 0:
        return x, half
    xld = -(-half // align) * align
    return F.pad(x.view(-1, 2, half), (0, xld - half)).contiguous(), xld


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
        C = gemv_splits(N, half, group,
                        _gemv_capacity(lib, x.get_device(), mode, M, group))
        xr, xld = _gemv_rows(x, half)
        ur = _gemv_rows(u, half)[0] if mode == "glu" else None
        err = lib.a3_int4_gemv(_GEMV_MODES[mode], p(xr),
                               None if ur is None else p(ur), p(q), p(scale),
                               None if res is None else p(res), p(out), M,
                               half, N, group, xld, C, _kernels.stream())
        return out, err
    _kernels.require(half % _TILE_MIN == 0 and _tile_group(mode, group),
                     f"{name}: K/2 ({half}) must be a multiple of "
                     f"{_TILE_MIN} and group ({group}) one of {_TILE_MIN} "
                     f"(or 32, v1 and glu) for M > {GEMV_MAX_M}")
    if mode == "glu":
        z = torch.empty_like(x)  # silu(g) * u, formed once by the kernel
        err = lib.a3_int4_mma_glu(p(x), p(u), p(q), p(scale), p(res), p(z),
                                  p(out), *tail)
    elif mode == "v3":
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
    N % 16 == 0; any group that divides Kpad/2 for M <= 32 (the GEMV, one
    launch), Kpad/2 % 64 == 0 and group % 64 == 0 above. Returns [M, N]
    bf16.
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
    with M <= 32 is quantized per row to int8 by one kernel
    (``quantize_act_int8``, which keeps its own launch count), then the
    GEMV contracts in integers, one launch. The weight as
    ``int4_matmul_2d``, any group that divides Kpad/2. Returns [M, N]
    bf16."""
    if x.device.type == "cpu":
        return int4_matmul_2d_w4a8_plain(x, q, scale, group)
    M, half, N = _require_int4("int4_matmul_w4a8", x, q, scale, group)
    _kernels.require(M <= GEMV_MAX_M, f"int4_matmul_w4a8: M={M} > "
                     f"{GEMV_MAX_M}")
    _kernels.require_cuda("int4_matmul_w4a8", x, dtype=torch.bfloat16)
    # padding the halves adds zeros, which leave each row's absmax and
    # quantize to 0
    xr, xld = _gemv_rows(x, half, 16)
    xq, xs = quantize_act_int8(xr.reshape(M, 2 * xld))
    out = torch.empty((M, N), dtype=torch.bfloat16, device=x.device)
    lib = _kernels.lib()
    C = gemv_splits(N, half, group,
                    _gemv_capacity(lib, x.get_device(), "w4a8", M, group))
    err = lib.a3_int4_gemv_a8(
        xq.data_ptr(), xs.data_ptr(), q.data_ptr(), scale.data_ptr(),
        out.data_ptr(), M, half, N, group, xld, C, _kernels.stream())
    int4_matmul_2d_w4a8.launches += 1
    _kernels.check(err, "a3_int4_gemv_a8")
    return out


int4_matmul_2d_w4a8.launches = 0


def int4_matmul_2d_w8a8p(x, q, scale, group: int):
    """Wrapper of the W8A8 prefill kernel (quant_matmul.py:299): x [M, Kpad]
    bf16 is quantized per row to int8 by one kernel (``quantize_act_int8``),
    and the ratios and column scales are formed from ``scale`` in tensor
    ops per call, as the JAX package does; the kernel requantizes the
    weights and contracts int8 x int8 on the tensor cores. Kpad/2 % 64 ==
    0 and group % 64 == 0, as the tiled route; the dispatcher sends other
    shapes to the plain math. Returns [M, N] bf16."""
    if x.device.type == "cpu":
        return int4_matmul_2d_w8a8p_plain(x, q, scale, group)
    M, half, N = _require_int4("int4_matmul_w8a8p", x, q, scale, group)
    _kernels.require(half % _TILE_MIN == 0 and group % _TILE_MIN == 0,
                     f"int4_matmul_w8a8p: K/2 ({half}) and group ({group}) "
                     f"must be multiples of {_TILE_MIN}")
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
    and K % 8 == 0 for M > 32 (the GEMV reads x as a padded copy where K %
    8 != 0). Returns [M, N] bf16."""
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
        xld = -(-K // 8) * 8
        xr = x if xld == K else F.pad(x, (0, xld - K)).contiguous()
        C = gemv_splits(N, K, GEMV_STAGE_ROWS, _gemv_capacity(
            lib, x.get_device(), "int8", M, GEMV_STAGE_ROWS))
        err = lib.a3_int8_gemv(xr.data_ptr(), q.data_ptr(), scale.data_ptr(),
                               out.data_ptr(), M, K, N, xld, C,
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


def _tile_group(mode: str, group: int) -> bool:
    """Groups the tiled route takes: multiples of 64, and 32 (the
    chunk-packed row-parallel weights, ``int4_chunked_geometry``) in the
    modes that scale every weight, "v1" and "glu"."""
    return group % _TILE_MIN == 0 or (group == 32 and mode in ("v1", "glu"))


def int4_kernel_takes(mode: str, M: int, half: int, N: int,
                      group: int) -> bool:
    """Whether the card's kernel of ``mode`` ("v1", "v3", "glu", "w4a8",
    "w8a8p") takes x [M, 2 half] against a packed weight [half, N] in groups
    of ``group``, from the shapes alone: N % 16 == 0 and a group that
    divides half for all; the GEMV (M <= 32) nothing more; the tiled routes
    (M > 32, and K8 at any M) half in multiples of 64 and a group in
    multiples of 64, or 32 in "v1" and "glu" (``_tile_group``)."""
    if N % 16 or group < 1 or half % group:
        return False
    if mode == "w4a8":
        return M <= GEMV_MAX_M
    if mode != "w8a8p" and M <= GEMV_MAX_M:
        return True
    return half % _TILE_MIN == 0 and _tile_group(mode, group)


def int8_kernel_takes(M: int, K: int, N: int) -> bool:
    """Whether the card's int8 kernel takes x [M, K] against [K, N]: N % 16
    == 0, and K % 8 == 0 for the tiled route (M > 32)."""
    return N % 16 == 0 and (M <= GEMV_MAX_M or K % 8 == 0)


def _int4_v1(x, q, scale, group: int):
    return int4_matmul_2d(x, q, scale, group, variant="v1")


# mode -> (kernel wrapper, its plain version, the reference's route where
# the kernel does not take the shape: _int4_matmul_xla for v1 and v3,
# _int4_w4a8_xla, _int4_w8a8p_xla; quant_matmul.py:961-968)
_INT4_ROUTES = {
    "v1": (_int4_v1, int4_matmul_2d_plain, int4_matmul_dense),
    "v3": (int4_matmul_2d_v3, int4_matmul_2d_v3_plain, int4_matmul_dense),
    "w4a8": (int4_matmul_2d_w4a8, int4_matmul_2d_w4a8_plain,
             int4_matmul_2d_w4a8_plain),
    "w8a8p": (int4_matmul_2d_w8a8p, int4_matmul_2d_w8a8p_plain,
              int4_matmul_2d_w8a8p_plain),
    "dense": (int4_matmul_dense, int4_matmul_dense, int4_matmul_dense),
}
INT4_FALLBACK = {mode: route[2] for mode, route in _INT4_ROUTES.items()
                 if mode != "dense"}


def int4_mode(M: int, variant: str = "auto", flags: bool = True) -> str:
    """The math ``int4_matmul`` takes for M rows under the mode flags, in
    the JAX dispatcher's order (quant_matmul.py:970-983): "w8a8p" (M >=
    ``W8A8_PREFILL_MIN_M``), "dense" (M >= ``PREFILL_DENSE_MIN_M``),
    "w4a8" (M <= ``W4A8_MAX_M``), else the exact kernel's variant, "v1" or
    "v3". ``flags=False``: "v1", whatever the flags say (a weight shard
    under a mesh; quant_matmul.py:956-960)."""
    if not flags:
        return "v1"
    if W8A8_PREFILL and M >= W8A8_PREFILL_MIN_M:
        return "w8a8p"
    if PREFILL_DENSE_MIN_M is not None and M >= PREFILL_DENSE_MIN_M:
        return "dense"
    if W4A8_DECODE and M <= W4A8_MAX_M:
        return "w4a8"
    variant = _AUTO_VARIANT if variant == "auto" else variant
    if variant not in ("v1", "v3"):
        raise ValueError(f"int4_matmul: variant {variant!r}")
    return variant


def int4_route(M: int, half: int, N: int, group: int, variant: str = "auto",
               impl: str = "auto", card: bool = True, flags: bool = True):
    """(function, fallback) that ``int4_matmul`` calls for x [M, 2 half]
    against a packed weight [half, N] in groups of ``group``: the mode's
    kernel wrapper (``impl="plain"``: its plain version), or, on the card
    where the kernel does not take the shape, the reference's route, with
    ``fallback`` the mode (else None). Shapes and flags alone decide."""
    mode = int4_mode(M, variant, flags)
    kernel, plain, fallback = _INT4_ROUTES[mode]
    if mode != "dense" and card and not int4_kernel_takes(mode, M, half, N,
                                                          group):
        return fallback, mode
    return (plain if impl == "plain" else kernel), None


def int4_matmul(x, qw: QuantizedWeight, impl: str = "auto",
                variant: str = "auto", flags: bool = True):
    """x [..., K] @ int4-packed weight -> [..., N] (quant_matmul.py:946):
    x is zero-padded to the packed K. With ``W8A8_PREFILL`` set, M >=
    ``W8A8_PREFILL_MIN_M`` rows take the W8A8 prefill math; then, with
    ``PREFILL_DENSE_MIN_M`` set, M >= it rows take the dense route
    (``int4_matmul_dense``); with ``W4A8_DECODE`` set, M <= ``W4A8_MAX_M``
    rows take the W4A8 math; the rest take the exact kernel in
    ``variant``. ``impl="plain"`` takes the same route through the plain
    versions, on any device. On the card a shape the mode's kernel does
    not take goes to the reference's route (``int4_route``), counted in
    ``int4_matmul.fallbacks``. The flags are read at every call
    (``flags=False`` ignores them). A chunk-packed weight runs chunk by
    chunk, the partials summed in float32 and cast once
    (``_int4_local_chunked``, quant_matmul.py:753)."""
    if qw.k_chunks > 1:
        return _int4_chunked(x, qw, impl, variant, flags)
    lead = x.shape[:-1]
    x2 = _pad_k(x, qw, "int4_matmul")
    half, N = qw.q.shape
    fn, fallback = int4_route(x2.shape[0], half, N, qw.group, variant, impl,
                              x2.is_cuda, flags)
    if fallback is not None:
        int4_matmul.fallbacks[fallback] += 1
    out = fn(x2, qw.q, qw.scale, qw.group)
    return out.reshape(*lead, out.shape[-1])


int4_matmul.fallbacks = {mode: 0 for mode in ("v1", "v3", "w4a8", "w8a8p",
                                              "glu")}


def _int4_chunked(x, qw: QuantizedWeight, impl: str, variant: str,
                  flags: bool):
    c = qw.k_chunks
    kc = 2 * qw.q.shape[-2]
    if x.shape[-1] != qw.in_dim:
        raise ValueError(f"int4_matmul: x has K={x.shape[-1]}, weight "
                         f"{qw.in_dim}")
    x = F.pad(x, (0, c * kc - x.shape[-1]))
    out = None
    for i in range(c):
        part = int4_matmul(x[..., i * kc:(i + 1) * kc], qw.chunk(i), impl,
                           variant, flags).float()
        out = part if out is None else out + part
    return out.to(x.dtype)


def sharded_matmul(x, w, impl: str = "auto"):
    """A rank's product with its block of a weight under a mesh of more
    than one rank, the counterpart of the per-shard bodies of
    ``_spmd_int4`` (quant_matmul.py:781), ``_spmd_int4_rowp`` (:838) and
    ``_spmd_int8`` (:1076): the exact int4 kernel (K1) on the local shape,
    whatever the mode flags, chunk by chunk for a run of chunks; the int8
    kernel (K6); a dense product. Where ``x`` records a gradient a
    quantized block goes through ``_QmatQuant``, so ``dx = g @ W^T`` of
    the local block (the JAX VJP, quant_matmul.py:1195-1204). A
    ``LoraWeight`` of local blocks adds ``(x @ a) @ b``. The collectives
    around it are the caller's (``parallel.tp``)."""
    if isinstance(w, LoraWeight):
        return (sharded_matmul(x, w.w, impl)
                + (x @ w.a.to(x.dtype)) @ w.b.to(x.dtype))
    if isinstance(w, QuantizedWeight):
        if torch.is_grad_enabled() and x.requires_grad:
            return _QmatQuant.apply(x, w.q, w.scale, w.bits, w.group,
                                    w.in_dim, w.k_chunks, impl, True)
        return _quant_matmul(x, w, impl, exact=True)
    return x @ w


def int4_ffn_down(g, u, qw: QuantizedWeight, res, impl: str = "auto"):
    """The fused FFN tail ``res + (silu(g) * u) @ W2`` in one kernel
    (quant_matmul.py:658). g, u [..., K], res [..., N]; ``qw`` a single
    layer's int4 weight. On the card a shape the fused kernel does not take
    goes through the unfused ops, as the JAX function's fallback does
    (counted in ``int4_matmul.fallbacks["glu"]``)."""
    lead = g.shape[:-1]
    half, N = qw.q.shape
    M = math.prod(lead)
    if g.is_cuda and not int4_kernel_takes("glu", M, half, N, qw.group):
        int4_matmul.fallbacks["glu"] += 1
        return res + int4_matmul(F.silu(g) * u, qw, impl)
    g2 = _pad_k(g, qw, "int4_ffn_down")
    u2 = _pad_k(u, qw, "int4_ffn_down")
    res2 = res.reshape(-1, res.shape[-1]).contiguous()
    fn = int4_matmul_2d_glu_plain if impl == "plain" else int4_matmul_2d_glu
    out = fn(g2, u2, qw.q, qw.scale, res2, qw.group)
    return out.reshape(*lead, out.shape[-1])


def int8_route(M: int, K: int, N: int, impl: str = "auto",
               card: bool = True):
    """(function, fallback) that ``int8_matmul`` calls for x [M, K] against
    [K, N]: the kernel wrapper (``impl="plain"``: its plain version), or on
    the card, where the kernel does not take the shape,
    ``int8_matmul_dense`` with ``fallback`` True."""
    if card and not int8_kernel_takes(M, K, N):
        return int8_matmul_dense, True
    return (int8_matmul_2d_plain if impl == "plain" else int8_matmul_2d,
            False)


def int8_matmul(x, qw: QuantizedWeight, impl: str = "auto"):
    """x [..., K] @ int8 weight [K, N] with one scale per output channel
    (quant_matmul.py:1124); on the card a shape the kernel does not take
    goes to ``int8_matmul_dense``, counted in ``int8_matmul.fallbacks``."""
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).contiguous()
    fn, fallback = int8_route(x2.shape[0], *qw.q.shape, impl, x2.is_cuda)
    if fallback:
        int8_matmul.fallbacks += 1
    out = fn(x2, qw.q, qw.scale.reshape(1, -1))
    return out.reshape(*lead, out.shape[-1])


int8_matmul.fallbacks = 0


def fallback_count() -> int:
    """Calls the dispatchers sent to a reference route since the last
    ``reset_fallbacks``."""
    return sum(int4_matmul.fallbacks.values()) + int8_matmul.fallbacks


def reset_fallbacks() -> None:
    for mode in int4_matmul.fallbacks:
        int4_matmul.fallbacks[mode] = 0
    int8_matmul.fallbacks = 0


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


def _quant_matmul(x, qw: QuantizedWeight, impl: str, exact: bool = False):
    """``int8_matmul`` or ``int4_matmul``; ``exact``: the exact int4 kernel
    whatever the mode flags say (a rank's block under a mesh)."""
    if qw.bits == 8:
        return int8_matmul(x, qw, impl)
    if exact:
        return int4_matmul(x, qw, impl, variant="v1", flags=False)
    return int4_matmul(x, qw, impl)


class _QmatQuant(torch.autograd.Function):
    """Differentiable linear over a frozen quantized base
    (quant_matmul.py:1177-1206): the forward is ``int4_matmul`` or
    ``int8_matmul`` (the kernel on CUDA tensors); the backward is
    ``g @ dequant(W)^T`` in g's dtype, the product of the dense weight's
    first ``in_dim`` rows, so the gradient has x's unpadded shape. The
    quantized ints and scales get no gradient. ``exact``: the forward is
    the exact kernel whatever the mode flags say (``sharded_matmul``)."""

    @staticmethod
    def forward(ctx, x, q, scale, bits: int, group: int, in_dim: int,
                k_chunks: int, impl: str, exact: bool):
        ctx.save_for_backward(q, scale)
        ctx.qw = (bits, group, in_dim, k_chunks)
        return _quant_matmul(x, QuantizedWeight(q, scale, bits, group,
                                                in_dim, k_chunks), impl,
                             exact)

    @staticmethod
    def backward(ctx, g):
        q, scale = ctx.saved_tensors
        w = _dequantize_leaf(QuantizedWeight(q, scale, *ctx.qw), g.dtype)
        return (g @ w.transpose(-1, -2),) + (None,) * 8


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
                                    w.in_dim, w.k_chunks, impl, False)
        return _quant_matmul(x, w, impl)
    return x @ w
