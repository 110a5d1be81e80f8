"""Each kernel's plain PyTorch version (what the port's wrappers run for CPU
tensors) against the Pallas kernel it replaces, in interpret mode, and
against the JAX package's plain path, on the same numpy inputs in float32.

Tolerances: int4 1e-4 (the weights below are exact in bf16, so the kernel's
bf16 weight rounding is lossless and only summation order differs over
K=1024); flash forward and lse 2e-3 (the Pallas kernel works in the base-2
exp domain, as tests/test_flash_attention.py allows); flash gradients 5e-3
as that file's gradient tests, and 2e-4 against the Pallas backward
kernels fed the same lse (only the score rounding differs); decode and ViT
1e-5 (f32 softmax on both sides)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu.ops import decode_attention as jda
from a3vlm_tpu.ops import flash_attention as jfa
from a3vlm_tpu.ops import quant_matmul as jqm
from a3vlm_tpu.ops.attention import sdpa_reference as j_sdpa
from a3vlm_tpu.ops.vit_attention import vit_attention as j_vit_attention
from a3vlm_tpu.quant import QuantizedWeight as JQuantizedWeight
from a3vlm_tpu_torch.ops.decode_attention import (
    decode_attention_update,
    decode_attention_update_plain,
)
from a3vlm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
)
from a3vlm_tpu_torch.ops.quant_matmul import (
    int4_matmul_2d,
    int4_matmul_2d_plain,
)
from a3vlm_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
)

torch.set_num_threads(1)


def _normal(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _assert_close(got, want, atol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_int4_plain_matches_pallas_and_xla():
    K, N, M, g = 1024, 256, 5, 64
    rng = np.random.default_rng(0)
    lo = rng.integers(-7, 8, size=(K // 2, N))
    hi = rng.integers(-7, 8, size=(K // 2, N))
    q = ((lo & 0x0F) | ((hi & 0x0F) << 4)).astype(np.uint8).view(np.int8)
    # power-of-two scales: nibble * scale is exact in bf16
    scale = (2.0 ** rng.integers(-6, -2, size=(K // g, N))).astype(np.float32)
    x = _normal((M, K), 1)

    pallas = jqm._int4_matmul_2d(jnp.asarray(x), jnp.asarray(q),
                                 jnp.asarray(scale), group=g, interpret=True)
    xla = jqm._int4_matmul_xla(
        jnp.asarray(x),
        JQuantizedWeight(jnp.asarray(q), jnp.asarray(scale), bits=4,
                         group=g, in_dim=K))
    tx, tq, ts = torch.tensor(x), torch.tensor(q), torch.tensor(scale)
    for got in (int4_matmul_2d_plain(tx, tq, ts, g),
                int4_matmul_2d(tx, tq, ts, g)):
        _assert_close(got, pallas, 1e-4)
        _assert_close(got, xla, 1e-4)


@pytest.mark.parametrize("hq,hkv,sq,skv", [(4, 2, 100, 200), (2, 2, 200, 200)])
def test_flash_plain_matches_pallas_and_sdpa(hq, hkv, sq, skv):
    """Ragged actual lengths inside padded arrays (sq_actual != skv_actual),
    GQA and right-aligned causal masking."""
    from jax.experimental.pallas import tpu as pltpu

    B, D, Sq, Skv = 1, 32, 256, 256
    q, k, v = (_normal((B, hq, Sq, D), 2), _normal((B, hkv, Skv, D), 3),
               _normal((B, hkv, Skv, D), 4))
    with pltpu.force_tpu_interpret_mode():
        pallas = jfa.flash_attention_bhsd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=128, block_k=128, sq_actual=sq, skv_actual=skv)
    plain = j_sdpa(
        jnp.asarray(q[:, :, :sq].transpose(0, 2, 1, 3)),
        jnp.asarray(k[:, :, :skv].transpose(0, 2, 1, 3)),
        jnp.asarray(v[:, :, :skv].transpose(0, 2, 1, 3)), "causal",
    ).transpose(0, 2, 1, 3)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    for got in (flash_attention_bhsd_plain(tq, tk, tv, True, sq, skv),
                flash_attention_bhsd(tq, tk, tv, True, sq, skv)):
        _assert_close(got[:, :, :sq], np.asarray(pallas)[:, :, :sq], 2e-3)
        _assert_close(got[:, :, :sq], plain, 1e-5)


def test_flash_lse_plain_matches_pallas():
    """K2's log-sum-exp output, ragged and GQA (the TPU layout's trailing
    8 copies are dropped)."""
    from jax.experimental.pallas import tpu as pltpu

    B, hq, hkv, D, S, sq, skv = 1, 4, 2, 32, 256, 100, 200
    q, k, v = (_normal((B, hq, S, D), 20), _normal((B, hkv, S, D), 21),
               _normal((B, hkv, S, D), 22))
    with pltpu.force_tpu_interpret_mode():
        _, lse = jfa.flash_attention_bhsd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
            block_q=128, block_k=128, sq_actual=sq, skv_actual=skv,
            return_lse=True)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    for fn in (flash_attention_bhsd_plain, flash_attention_bhsd):
        out, got = fn(tq, tk, tv, True, sq, skv, return_lse=True)
        assert got.shape == (B, hq, S) and got.dtype == torch.float32
        _assert_close(got[:, :, :sq], np.asarray(lse)[:, :, :sq, 0], 2e-3)
        _assert_close(out, fn(tq, tk, tv, True, sq, skv), 0)


@pytest.mark.parametrize("hq,hkv,sq,skv", [
    (4, 2, 256, 256),      # GQA
    (2, 2, 200, 200),      # ragged
    (2, 2, 128, 384),      # right-aligned unequal
    (2, 1, 100, 300),      # GQA + ragged + unequal
])
def test_flash_backward_matches_jax_grad(hq, hkv, sq, skv):
    """The plain backward and the CPU ``FlashAttention`` op against
    ``jax.grad`` through the Pallas forward and K9 backward kernels and
    through ``sdpa_reference`` (the variants of
    tests/test_flash_attention.py:122-127), to 5e-3 as there."""
    from jax.experimental.pallas import tpu as pltpu

    B, D = 1, 32
    q, k, v = (_normal((B, sq, hq, D), 30), _normal((B, skv, hkv, D), 31),
               _normal((B, skv, hkv, D), 32))
    w = _normal((B, sq, hq, D), 33)

    def j_loss(attn):
        return lambda q, k, v: jnp.sum(attn(q, k, v) * w)

    with pltpu.force_tpu_interpret_mode():
        pallas = jax.grad(j_loss(lambda q, k, v: jfa.flash_attention(
            q, k, v, True, 128, 128)), argnums=(0, 1, 2))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = jax.grad(j_loss(lambda q, k, v: j_sdpa(q, k, v, "causal")),
                   argnums=(0, 1, 2))(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v))

    bhsd = [torch.tensor(x).transpose(1, 2).contiguous() for x in (q, k, v)]
    tw = torch.tensor(w).transpose(1, 2).contiguous()
    out, lse = flash_attention_bhsd_plain(*bhsd, True, return_lse=True)
    plain = [g.transpose(1, 2)
             for g in flash_attention_bwd_plain(*bhsd, out, lse, tw)]
    leaves = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    op = torch.autograd.grad(
        (flash_attention(*leaves) * torch.tensor(w)).sum(), leaves)
    for got in (plain, op):
        for g, p_, r in zip(got, pallas, ref):
            _assert_close(g, p_, 5e-3)
            _assert_close(g, r, 5e-3)


def test_flash_backward_plain_matches_pallas_kernels_padded():
    """The K9a/K9b plain versions on right-padded arrays with actual
    lengths, against the Pallas backward kernels themselves
    (_flash_backward_bhsd) on the same padded inputs: padded rows carry a
    zero ``do``, padded keys get zero gradient, and the GQA group is summed
    (the Pallas kernels leave that sum to their caller)."""
    from jax.experimental.pallas import tpu as pltpu

    B, hq, hkv, D, S, sq, skv = 1, 4, 2, 32, 256, 100, 200
    q, k, v = (_normal((B, hq, S, D), 40), _normal((B, hkv, S, D), 41),
               _normal((B, hkv, S, D), 42))
    do = _normal((B, hq, S, D), 43)
    do[:, :, sq:] = 0.0
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    out, lse = flash_attention_bhsd_plain(tq, tk, tv, True, sq, skv,
                                          return_lse=True)
    delta = (tdo * out).sum(-1)
    rows = lambda x: jnp.broadcast_to(jnp.asarray(x.numpy())[..., None],
                                      (*x.shape, 8))
    with pltpu.force_tpu_interpret_mode():
        dq, dk_h, dv_h = jfa._flash_backward_bhsd(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(do),
            rows(lse), rows(delta), True, 128, 128, sq, skv)
    dk = np.asarray(dk_h).reshape(B, hkv, hq // hkv, S, D).sum(2)
    dv = np.asarray(dv_h).reshape(B, hkv, hq // hkv, S, D).sum(2)
    want = (dq, dk, dv)
    for fn_dq, fn_dkv in ((flash_attention_bwd_dq_plain,
                           flash_attention_bwd_dkv_plain),
                          (flash_attention_bwd_dq, flash_attention_bwd_dkv)):
        got = (fn_dq(tq, tk, tv, tdo, lse, delta, True, sq, skv),
               *fn_dkv(tq, tk, tv, tdo, lse, delta, True, sq, skv))
        for g, w_ in zip(got, want):
            _assert_close(g, w_, 2e-4)
        assert float(got[1][:, :, skv:].abs().max()) == 0.0


@pytest.mark.parametrize("S", [64, 520])
def test_decode_plain_matches_pallas_and_two_step(S):
    """S=64 runs the single-panel TPU kernel, S=520 the blocked one. The
    caches after the write are bit-identical, rows != pos included."""
    B, Hkv, G, D = 2, 2, 2, 128
    q = _normal((B, Hkv, G, D), 5)
    ck, cv = _normal((B, Hkv, S, D), 6), _normal((B, Hkv, S, D), 7)
    nk, nv = _normal((B, Hkv, D), 8), _normal((B, Hkv, D), 9)
    pos = np.array([3, S - 1], np.int32)
    valid = pos + 1

    out_j, k_j, v_j = jda._decode_update_impl(
        jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv),
        jnp.asarray(nk[:, :, None]), jnp.asarray(nv[:, :, None]),
        jnp.asarray(pos), jnp.asarray(valid), interpret=True)
    k_ref, v_ref = jda._update_decode_cache_ragged(
        jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(nk[:, None]),
        jnp.asarray(nv[:, None]), jnp.asarray(pos))
    two_step = j_sdpa(
        jnp.asarray(q.reshape(B, 1, Hkv * G, D)),
        k_ref.transpose(0, 2, 1, 3), v_ref.transpose(0, 2, 1, 3), None,
        jnp.asarray(valid),
    ).reshape(B, Hkv, G, D)

    for fn in (decode_attention_update_plain, decode_attention_update):
        tck, tcv = torch.tensor(ck), torch.tensor(cv)
        out = fn(torch.tensor(q), tck, tcv, torch.tensor(nk),
                 torch.tensor(nv), torch.tensor(pos), torch.tensor(valid))
        _assert_close(out, out_j, 1e-5)
        _assert_close(out, two_step, 1e-5)
        np.testing.assert_array_equal(tck.numpy(), np.asarray(k_j))
        np.testing.assert_array_equal(tcv.numpy(), np.asarray(v_j))
        np.testing.assert_array_equal(tck.numpy(), np.asarray(k_ref))


@pytest.mark.parametrize("H,D", [(4, 64), (2, 88)])
def test_vit_plain_matches_pallas_and_sdpa(H, D):
    B, S = 2, 17
    q, k, v = (_normal((B, S, H, D), 10), _normal((B, S, H, D), 11),
               _normal((B, S, H, D), 12))
    pallas = j_vit_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             interpret=True)
    plain = j_sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), None)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    for got in (vit_attention_plain(tq, tk, tv), vit_attention(tq, tk, tv)):
        _assert_close(got, pallas, 1e-5)
        _assert_close(got, plain, 1e-5)


def test_wrappers_count_no_cpu_launches():
    """On CPU tensors the wrappers take the plain version and count no
    kernel launch."""
    counted = (int4_matmul_2d, flash_attention_bhsd, flash_attention_bwd_dq,
               flash_attention_bwd_dkv, decode_attention_update,
               vit_attention)
    before = [f.launches for f in counted]
    x = torch.zeros(2, 128)
    int4_matmul_2d(x, torch.zeros(64, 16, dtype=torch.int8),
                   torch.ones(2, 16), 64)
    t = torch.zeros(1, 2, 8, 32)
    rows = torch.zeros(1, 2, 8)
    flash_attention_bhsd(t, t, t)
    flash_attention_bwd_dq(t, t, t, t, rows, rows)
    flash_attention_bwd_dkv(t, t, t, t, rows, rows)
    vit_attention(t, t, t)
    after = [f.launches for f in counted]
    assert before == after
