"""Non-causal attention for the vision towers (counterpart of
a3vlm_tpu/ops/vit_attention.py; kernel in csrc/vit_attention.cu).

``vit_attention`` is the kernel's wrapper: CUDA tensors launch the kernel,
CPU tensors take ``vit_attention_plain``."""

from __future__ import annotations

import math

import torch

from a3vlm_tpu_torch.ops import _kernels

_LOG2E = 1.4426950408889634


def vit_attention_plain(q, k, v):
    """q, k, v [B, S, H, D] -> [B, S, H, D]: full softmax attention with
    float32 scores."""
    D = q.shape[-1]
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * D ** -0.5
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)


def vit_attention_eligible(q: torch.Tensor) -> bool:
    """bshd bf16 with head dim <= 128. The JAX gate's B >= 8 and TPU-only
    conditions were TPU measurements and do not apply here. S is not
    gated: an S whose K and V do not fit the kernel's shared memory raises
    in the kernel's launch, it never takes the plain path on the card."""
    return q.dtype == torch.bfloat16 and q.shape[-1] <= 128


def _row_stride(t: torch.Tensor) -> int | None:
    """The row stride of a [B, S, H, D] view that the kernel reads in place
    (heads D apart, batches S rows apart, elements contiguous, rows not
    overlapping), else None."""
    B, S, H, D = t.shape
    sb, ss, sh, sd = t.stride()
    ok = (sd == 1 and (H == 1 or sh == D) and ss >= H * D
          and (B == 1 or sb == S * ss))
    return ss if ok else None


def vit_attention(q, k, v):
    """Wrapper of the tower attention kernel (vit_attention.py:52).
    q, k, v [B, S, H, D] bf16, read in place where each is a view whose
    heads lie D apart and batches S rows apart (the tower's split of one
    [B, S, 3W] projection), copied to contiguous otherwise. Returns a
    contiguous [B, S, H, D]. The launch fails (RuntimeError) where K and V
    of one (crop, head) do not fit a block's shared memory (the limit on S
    is in csrc/vit_attention.cu; the towers' S 257 fits)."""
    if q.device.type == "cpu":
        return vit_attention_plain(q, k, v)
    B, S, H, D = q.shape
    _kernels.require(k.shape == q.shape and v.shape == q.shape,
                     "vit_attention: q/k/v shapes differ")
    _kernels.require(0 < D <= 128, "vit_attention: head dim must be <= 128")
    # messages are formatted only on failure: the call is short enough at 5
    # crops for the host's share to show
    ops, strides = [], []
    for t in (q, k, v):
        ld = _row_stride(t)
        if ld is None:
            t, ld = t.contiguous(), H * D
        if not (t.is_cuda and t.dtype == torch.bfloat16):
            raise ValueError(f"vit_attention: want bf16 on cuda, got "
                             f"{t.dtype} on {t.device}")
        ops.append(t)
        strides.append(ld)
    out = torch.empty((B, S, H, D), dtype=q.dtype, device=q.device)
    err = _kernels.lib().a3_vit_attention(
        *(t.data_ptr() for t in ops), out.data_ptr(), B, S, H, D, *strides,
        _LOG2E / math.sqrt(D), _kernels.stream(),
    )
    _kernels.check(err, "a3_vit_attention")
    vit_attention.launches += 1
    return out


vit_attention.launches = 0
