"""Causal flash attention, forward and backward (counterpart of
a3vlm_tpu/ops/flash_attention.py; kernels in csrc/flash_attention.cu and
csrc/flash_attention_bwd.cu).

``flash_attention_bhsd``, ``flash_attention_bwd_dq`` and
``flash_attention_bwd_dkv`` are the kernels' wrappers: CUDA tensors launch
the kernel, CPU tensors take the ``*_plain`` function of the same math in
plain PyTorch. ``FlashAttention`` is the differentiable op (the JAX
``custom_vjp`` at :301/:562/:583): the forward kernel with its log-sum-exp,
and a backward that forms ``delta = rowsum(do * o)`` and launches the two
backward kernels. The kernels take ragged lengths directly, so nothing is
padded."""

from __future__ import annotations

import math

import torch

from a3vlm_tpu_torch.ops import _kernels

_LOG2E = 1.4426950408889634


def _visible(Sq: int, Skv: int, causal: bool, sq_a: int, skv_a: int,
             device) -> torch.Tensor:
    """[Sq, Skv] bool: row r sees key c iff c < skv_a and (when causal)
    r - sq_a >= c - skv_a."""
    rows = torch.arange(Sq, device=device)[:, None]
    cols = torch.arange(Skv, device=device)[None, :]
    allowed = cols < skv_a
    if causal:
        allowed = allowed & (rows - sq_a >= cols - skv_a)
    return allowed


def _scores(q, k, sq_a, skv_a, causal):
    """Natural-domain scaled scores [B, Hkv, G, Sq, Skv] in float32, -inf
    where masked."""
    B, Hq, Sq, D = q.shape
    Hkv, Skv = k.shape[1], k.shape[2]
    qf = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D) * D ** -0.5
    s = torch.einsum("bhgqd,bhkd->bhgqk", qf, k.float())
    allowed = _visible(Sq, Skv, causal, sq_a, skv_a, q.device)
    return s.masked_fill(~allowed, float("-inf"))


def flash_attention_bhsd_plain(q, k, v, causal: bool = True,
                               sq_actual: int | None = None,
                               skv_actual: int | None = None,
                               return_lse: bool = False):
    """q [B, Hq, Sq, D], k/v [B, Hkv, Skv, D] -> [B, Hq, Sq, D]: softmax
    attention in float32, row r seeing key c iff c < skv_actual and (when
    causal) r - sq_actual >= c - skv_actual. Rows with no visible key give
    zeros. With ``return_lse`` also the natural-log log-sum-exp of each
    row's scaled scores, [B, Hq, Sq] float32 (-inf for an empty row)."""
    B, Hq, Sq, D = q.shape
    s = _scores(q, k, sq_actual or Sq, skv_actual or k.shape[2], causal)
    p = torch.softmax(s, dim=-1).nan_to_num(0.0)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v.float())
    out = out.reshape(B, Hq, Sq, D).to(q.dtype)
    if return_lse:
        return out, torch.logsumexp(s, dim=-1).reshape(B, Hq, Sq)
    return out


def flash_attention_bhsd(q, k, v, causal: bool = True,
                         sq_actual: int | None = None,
                         skv_actual: int | None = None,
                         return_lse: bool = False):
    """Wrapper of the flash kernel (flash_attention.py:199). q [B, Hq, Sq,
    D], k/v [B, Hkv, Skv, D] bf16, contiguous; D <= 128; Hq % Hkv == 0.
    ``return_lse`` also returns the [B, Hq, Sq] float32 log-sum-exp."""
    if q.device.type == "cpu":
        return flash_attention_bhsd_plain(q, k, v, causal, sq_actual,
                                          skv_actual, return_lse)
    B, Hq, Sq, D = q.shape
    Skv, sq_a, skv_a = _check(q, k, v, sq_actual, skv_actual, "flash")
    out = torch.empty_like(q)
    lse = (torch.empty((B, Hq, Sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    err = _kernels.lib().a3_flash_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        None if lse is None else lse.data_ptr(), B, Hq, k.shape[1], Sq, Skv,
        D, sq_a, skv_a, _LOG2E / math.sqrt(D), int(causal),
        _kernels.stream(),
    )
    flash_attention_bhsd.launches += 1
    flash_attention_bhsd.lse_launches += int(return_lse)
    _kernels.check(err, "a3_flash_fwd")
    return (out, lse) if return_lse else out


flash_attention_bhsd.launches = 0
flash_attention_bhsd.lse_launches = 0  # the launches that wrote lse


def _check(q, k, v, sq_actual, skv_actual, name):
    """Shape, type and length checks shared by the kernel wrappers;
    returns (Skv, sq_actual, skv_actual)."""
    B, Hq, Sq, D = q.shape
    _kernels.require(k.dim() == 4 and k.shape == v.shape, f"{name}: k/v shape")
    Hkv, Skv = k.shape[1], k.shape[2]
    _kernels.require(k.shape[0] == B and k.shape[3] == D, f"{name}: q/k shape")
    _kernels.require(Hq % Hkv == 0, f"{name}: Hq % Hkv != 0")
    _kernels.require(0 < D <= 128, f"{name}: head dim must be <= 128")
    _kernels.require_cuda(name, q, k, v, dtype=torch.bfloat16)
    sq_a = sq_actual or Sq
    skv_a = skv_actual or Skv
    _kernels.require(0 < sq_a <= Sq and 0 < skv_a <= Skv,
                     f"{name}: actual lengths out of range")
    return Skv, sq_a, skv_a


def _probs_and_ds(q, k, v, do, lse, delta, causal, sq_a, skv_a):
    """p and ds [B, Hkv, G, Sq, Skv] float32 as the backward kernels form
    them: p = exp(s - lse) (0 where masked or where lse = -inf) and
    ds = p (do.v - delta) / sqrt(D)."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    s = _scores(q, k, sq_a, skv_a, causal)
    lse_g = lse.reshape(B, Hkv, G, Sq, 1)
    p = torch.exp(s - lse_g.masked_fill(torch.isinf(lse_g), 0.0))
    p = p.masked_fill(torch.isinf(lse_g), 0.0)
    dp = torch.einsum("bhgqd,bhkd->bhgqk",
                      do.float().reshape(B, Hkv, G, Sq, D), v.float())
    ds = p * (dp - delta.reshape(B, Hkv, G, Sq, 1)) * D ** -0.5
    return p, ds


def flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal=True,
                                 sq_actual=None, skv_actual=None):
    """dq [B, Hq, Sq, D] in q's dtype: sum over keys of ds * k, with ds
    rounded to the input dtype first (flash_attention.py:385)."""
    B, Hq, Sq, D = q.shape
    _, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sq_actual or Sq,
                          skv_actual or k.shape[2])
    dq = torch.einsum("bhgqk,bhkd->bhgqd", ds.to(q.dtype).float(), k.float())
    return dq.reshape(B, Hq, Sq, D).to(q.dtype)


def flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal=True,
                                  sq_actual=None, skv_actual=None):
    """(dk, dv) [B, Hkv, Skv, D] in k's dtype, the GQA group summed: sums
    over rows of ds * q and p * do, with p and ds rounded to the input dtype
    first (flash_attention.py:440, :450)."""
    B, Hq, Sq, D = q.shape
    Hkv = k.shape[1]
    p, ds = _probs_and_ds(q, k, v, do, lse, delta, causal, sq_actual or Sq,
                          skv_actual or k.shape[2])
    qg = q.float().reshape(B, Hkv, Hq // Hkv, Sq, D)
    dog = do.float().reshape(B, Hkv, Hq // Hkv, Sq, D)
    dk = torch.einsum("bhgqk,bhgqd->bhkd", ds.to(q.dtype).float(), qg)
    dv = torch.einsum("bhgqk,bhgqd->bhkd", p.to(q.dtype).float(), dog)
    return dk.to(k.dtype), dv.to(v.dtype)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, causal: bool = True,
                           sq_actual: int | None = None,
                           skv_actual: int | None = None):
    """Wrapper of the dq kernel (K9a, flash_attention.py:358). q, do
    [B, Hq, Sq, D] and k, v [B, Hkv, Skv, D] bf16; lse, delta [B, Hq, Sq]
    float32; all contiguous. Returns dq [B, Hq, Sq, D] bf16."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                            sq_actual, skv_actual)
    B, Hq, Sq, D = q.shape
    Skv, sq_a, skv_a = _check(q, k, v, sq_actual, skv_actual, "flash_bwd_dq")
    _check_rows(q, do, lse, delta, "flash_bwd_dq")
    dq = torch.empty_like(q)
    err = _kernels.lib().a3_flash_bwd_dq(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), B, Hq, k.shape[1],
        Sq, Skv, D, sq_a, skv_a, _LOG2E / math.sqrt(D), 1 / math.sqrt(D),
        int(causal), _kernels.stream(),
    )
    flash_attention_bwd_dq.launches += 1
    _kernels.check(err, "a3_flash_bwd_dq")
    return dq


flash_attention_bwd_dq.launches = 0


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal: bool = True,
                            sq_actual: int | None = None,
                            skv_actual: int | None = None):
    """Wrapper of the dk/dv kernel (K9b, flash_attention.py:414); inputs as
    ``flash_attention_bwd_dq``. Returns (dk, dv) [B, Hkv, Skv, D] bf16 with
    the GQA group summed in the kernel."""
    if q.device.type == "cpu":
        return flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                             sq_actual, skv_actual)
    B, Hq, Sq, D = q.shape
    Skv, sq_a, skv_a = _check(q, k, v, sq_actual, skv_actual,
                              "flash_bwd_dkv")
    _check_rows(q, do, lse, delta, "flash_bwd_dkv")
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    err = _kernels.lib().a3_flash_bwd_dkv(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
        lse.data_ptr(), delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), B,
        Hq, k.shape[1], Sq, Skv, D, sq_a, skv_a, _LOG2E / math.sqrt(D),
        1 / math.sqrt(D), int(causal), _kernels.stream(),
    )
    flash_attention_bwd_dkv.launches += 1
    _kernels.check(err, "a3_flash_bwd_dkv")
    return dk, dv


flash_attention_bwd_dkv.launches = 0


def _check_rows(q, do, lse, delta, name):
    _kernels.require(do.shape == q.shape, f"{name}: do shape")
    _kernels.require(lse.shape == q.shape[:3] and delta.shape == q.shape[:3],
                     f"{name}: lse/delta shape")
    _kernels.require_cuda(name, do, dtype=torch.bfloat16)
    _kernels.require_cuda(name, lse, delta, dtype=torch.float32)


def flash_attention_bwd(q, k, v, o, lse, do, causal: bool = True,
                        sq_actual: int | None = None,
                        skv_actual: int | None = None):
    """(dq, dk, dv) of ``flash_attention_bhsd`` from its output ``o`` and
    log-sum-exp (flash_attention.py:583): delta = rowsum(do * o) in float32
    from the output as the forward returned it (plain PyTorch, as it is XLA
    in the JAX package), then the dq and dk/dv kernels."""
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq(q, k, v, do, lse, delta, causal, sq_actual,
                                skv_actual)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, causal,
                                     sq_actual, skv_actual)
    return dq, dk, dv


def flash_attention_bwd_plain(q, k, v, o, lse, do, causal: bool = True,
                              sq_actual: int | None = None,
                              skv_actual: int | None = None):
    """``flash_attention_bwd`` with the plain versions on any device."""
    delta = (do.float() * o.float()).sum(-1)
    dq = flash_attention_bwd_dq_plain(q, k, v, do, lse, delta, causal,
                                      sq_actual, skv_actual)
    dk, dv = flash_attention_bwd_dkv_plain(q, k, v, do, lse, delta, causal,
                                           sq_actual, skv_actual)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention over bhsd tensors. The forward is a
    pure function of its inputs, so ``torch.utils.checkpoint`` may run it
    again (each run launches the forward kernel again)."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool):
        out, lse = flash_attention_bhsd(q, k, v, causal=causal,
                                        return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, do.contiguous(),
                                         ctx.causal)
        return dq, dk, dv, None


def flash_attention(q, k, v, causal: bool = True):
    """Model-layout entry (flash_attention.py:302): q [B, Sq, Hq, D],
    k/v [B, Skv, Hkv, D] -> [B, Sq, Hq, D], differentiable. Without a
    gradient to record (serving) the forward kernel writes no lse."""
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        out = FlashAttention.apply(qt, kt, vt, causal)
    else:
        out = flash_attention_bhsd(qt, kt, vt, causal=causal)
    return out.transpose(1, 2)
