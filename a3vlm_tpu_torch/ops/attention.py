"""Attention with the reference's mask semantics (counterpart of
a3vlm_tpu/ops/attention.py).

Mask contract: ``"causal"`` is right-aligned (query row ``i`` of ``q_len``
sees key ``j`` of ``kv_len`` iff ``i - q_len >= j - kv_len``); ``None`` is
full attention; a boolean tensor is True = attend. Softmax runs in float32.
GQA broadcasts kv head ``h // (Hq / Hkv)``."""

from __future__ import annotations

import torch

_NEG_INF = -0.7 * torch.finfo(torch.float32).max


def right_aligned_causal_mask(q_len: int, kv_len: int,
                              device: torch.device | str) -> torch.Tensor:
    """Boolean [q_len, kv_len]; True = may attend (attention.py:28)."""
    q_idx = torch.arange(q_len, device=device)[:, None] - q_len
    kv_idx = torch.arange(kv_len, device=device)[None, :] - kv_len
    return q_idx >= kv_idx


def sdpa_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | str | None = None,
                   kv_valid_len: torch.Tensor | None = None) -> torch.Tensor:
    """Plain scaled-dot-product attention in float32 (attention.py:36).

    q [B, Sq, Hq, D]; k, v [B, Skv, Hkv, D]. ``kv_valid_len`` [B] masks
    keys at index >= valid_len and, with "causal", is the right-aligned
    reference point. Returns [B, Sq, Hq, D] in q's dtype."""
    B, Sq, Hq, D = q.shape
    Skv, Hkv = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qf = q.float() * (D ** -0.5)
    scores = torch.einsum(
        "bqhgd,bkhd->bhgqk", qf.reshape(B, Sq, Hkv, group, D), k.float()
    )
    dev = q.device
    if isinstance(mask, str):
        if mask != "causal":
            raise NotImplementedError(mask)
        if kv_valid_len is None:
            m = right_aligned_causal_mask(Sq, Skv, dev)[None, None, None]
        else:
            q_pos = (kv_valid_len[:, None] - Sq
                     + torch.arange(Sq, device=dev)[None, :])
            m = (torch.arange(Skv, device=dev)[None, None, :]
                 <= q_pos[:, :, None])[:, None, None]
    elif mask is None:
        m = None
        if kv_valid_len is not None:
            m = (torch.arange(Skv, device=dev)[None, :]
                 < kv_valid_len[:, None])[:, None, None, None]
    else:
        m = mask.bool()
        while m.dim() < 5:
            m = m[None]
    if m is not None:
        scores = torch.where(m, scores, torch.full_like(scores, _NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs, v.float())
    return out.reshape(B, Sq, Hq, D).to(q.dtype)


def flash_eligible(q: torch.Tensor, mask, kv_valid_len) -> bool:
    """Shapes and types the causal flash kernel takes. The JAX dispatcher's
    TPU-measured gates (Sq >= 512, TPU only) do not apply here."""
    return (
        isinstance(mask, str) and mask == "causal"
        and kv_valid_len is None
        and q.dtype == torch.bfloat16
        and q.shape[-1] <= 128
    )


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              mask: torch.Tensor | str | None = None,
              kv_valid_len: torch.Tensor | None = None,
              impl: str = "auto") -> torch.Tensor:
    """Dispatching attention (attention.py:163): the differentiable flash
    op (kernels on CUDA tensors, their plain versions on CPU ones) for
    eligible bf16 inputs under ``impl="auto"`` and for any causal or
    unmasked input under ``impl="flash"``; the plain path for everything
    else and for ``impl="plain"``."""
    is_causal = isinstance(mask, str) and mask == "causal"
    if impl == "flash" and (kv_valid_len is not None
                            or not (is_causal or mask is None)):
        raise ValueError("impl='flash' takes a causal or no mask and no "
                         "kv_valid_len")
    if impl == "flash" or (impl == "auto"
                           and flash_eligible(q, mask, kv_valid_len)):
        from a3vlm_tpu_torch.ops.flash_attention import flash_attention

        return flash_attention(q, k, v, causal=is_causal)
    return sdpa_reference(q, k, v, mask=mask, kv_valid_len=kv_valid_len)
