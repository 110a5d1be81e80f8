"""Each kernel's plain PyTorch version (what the port's wrappers run for CPU
tensors) against the Pallas kernel it replaces, in interpret mode, and
against the JAX package's plain path, on the same numpy inputs in float32.

Tolerances: int4 1e-4 (the weights below are exact in bf16, so the kernel's
bf16 weight rounding is lossless and only summation order differs over
K=1024); flash forward and lse 2e-3 (the Pallas kernel works in the base-2
exp domain, as tests/test_flash_attention.py allows); flash gradients 5e-3
as that file's gradient tests, and 2e-4 against the Pallas backward
kernels fed the same lse (only the score rounding differs); decode and ViT
1e-5 (f32 softmax on both sides); the flash forward, lse and dq at the tile
edges 1e-5 against the JAX package's plain attention. The decode and verify kernels of the
latency path (bf16 and int8 caches): 1e-5 on float32 inputs; on bf16
inputs 2^-6 of the largest output (the Pallas blocked kernels round the
softmax weights to bf16 before the pv product, the plain versions keep
them in float32); quantized values, scales and caches exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu.ops import decode_attention as jda
from a3vlm_tpu.ops import flash_attention as jfa
from a3vlm_tpu.ops import quant_matmul as jqm
from a3vlm_tpu.ops.attention import sdpa_reference
from a3vlm_tpu.ops.vit_attention import vit_attention as j_vit_attention
from a3vlm_tpu.quant import QuantizedWeight as JQuantizedWeight
from a3vlm_tpu_torch.ops import decode_attention as dec
from a3vlm_tpu_torch.ops.decode_attention import (
    QuantizedKV,
    decode_attention,
    decode_attention_plain,
    decode_attention_quant,
    decode_attention_quant_plain,
    decode_attention_update,
    decode_attention_update_plain,
    decode_attention_update_quant,
    decode_attention_update_quant_plain,
    quantize_kv_tokens,
    update_decode_cache,
    verify_attention,
    verify_attention_plain,
    verify_attention_quant,
    verify_attention_quant_plain,
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
from a3vlm_tpu_torch.ops import quant_matmul as qmm
from a3vlm_tpu_torch.ops.quant_matmul import (
    int4_matmul_2d,
    int4_matmul_2d_plain,
)
from a3vlm_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
)

# the JAX package's plain attention jitted (the mask, a string or None,
# static): one compile a shape in place of one for every op
j_sdpa = jax.jit(sdpa_reference, static_argnums=3)

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
        pallas = jax.jit(jax.grad(j_loss(lambda q, k, v: jfa.flash_attention(
            q, k, v, True, 128, 128)), argnums=(0, 1, 2)))(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    ref = jax.jit(jax.grad(j_loss(lambda q, k, v: j_sdpa(q, k, v, "causal")),
                           argnums=(0, 1, 2)))(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))

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


# The edges the tensor-core tile has code for: lengths on both sides of its
# 64-key (backward) and 128-key (forward) tiles and of the 64 rows of a
# warpgroup and the 128 of a forward block, fewer queries than keys
# (right-aligned), actual lengths inside padded arrays, a GQA group of 5,
# head dims 64 and 128, and no mask.
# hq, hkv, Sq, Skv, D, causal, sq_actual, skv_actual
_TILE_EDGES = [
    (2, 2, 63, 63, 64, True, None, None),
    (2, 2, 64, 64, 128, True, None, None),
    (2, 2, 65, 65, 64, True, None, None),
    (2, 2, 127, 127, 64, True, None, None),
    (2, 2, 129, 129, 128, True, None, None),
    (2, 2, 63, 129, 64, True, None, None),
    (5, 1, 65, 127, 64, True, None, None),
    (10, 2, 64, 129, 128, True, None, None),
    (2, 2, 129, 127, 64, False, None, None),
    (5, 1, 65, 64, 128, False, None, None),
    (2, 2, 128, 192, 64, True, 127, 129),
    (5, 1, 128, 192, 128, True, 63, 65),
    (2, 2, 192, 128, 64, False, 129, 63),
]


def _edge_inputs(hq, hkv, Sq, Skv, D, seed):
    return (_normal((1, hq, Sq, D), seed), _normal((1, hkv, Skv, D), seed + 1),
            _normal((1, hkv, Skv, D), seed + 2))


def _bshd(x, n):
    """The first ``n`` rows of a bhsd numpy array in the model layout."""
    return jnp.asarray(x[:, :, :n].transpose(0, 2, 1, 3))


@pytest.mark.parametrize("hq,hkv,Sq,Skv,D,causal,sq_a,skv_a", _TILE_EDGES)
def test_flash_plain_tile_edges(hq, hkv, Sq, Skv, D, causal, sq_a, skv_a):
    """The forward's plain version and CPU wrapper, output and lse, against
    the JAX package's plain attention on the actual rows and keys; 1e-5 in
    float32 (the same f32 softmax on both sides)."""
    q, k, v = _edge_inputs(hq, hkv, Sq, Skv, D, 50)
    sq, skv = sq_a or Sq, skv_a or Skv
    mask = "causal" if causal else None
    want = np.asarray(j_sdpa(_bshd(q, sq), _bshd(k, skv), _bshd(v, skv),
                             mask)).transpose(0, 2, 1, 3)
    scores = jnp.einsum("bqhgd,bkhd->bhgqk",
                        _bshd(q, sq).reshape(1, sq, hkv, hq // hkv, D),
                        _bshd(k, skv)) * D ** -0.5
    if causal:
        rows = jnp.arange(sq)[:, None] - sq
        scores = jnp.where(rows >= jnp.arange(skv)[None, :] - skv, scores,
                           -jnp.inf)
    want_lse = np.asarray(jax.nn.logsumexp(scores, axis=-1)).reshape(1, hq, sq)
    tq, tk, tv = torch.tensor(q), torch.tensor(k), torch.tensor(v)
    for fn in (flash_attention_bhsd_plain, flash_attention_bhsd):
        got, lse = fn(tq, tk, tv, causal, sq_a, skv_a, return_lse=True)
        assert got.shape == (1, hq, Sq, D) and lse.shape == (1, hq, Sq)
        _assert_close(got[:, :, :sq], want, 1e-5)
        _assert_close(lse[:, :, :sq], want_lse, 1e-5)


@pytest.mark.parametrize("hq,hkv,Sq,Skv,D,causal,sq_a,skv_a", _TILE_EDGES)
def test_flash_bwd_dq_plain_tile_edges(hq, hkv, Sq, Skv, D, causal, sq_a,
                                       skv_a):
    """K9a's and K9b's plain versions and CPU wrappers against one
    ``jax.grad`` (with respect to q, k and v) through the JAX package's
    plain attention on the actual rows and keys (``do`` is zero on the
    padded rows); 1e-5 in float32, where p and ds are not rounded. Padded
    keys get zero dk and dv."""
    q, k, v = _edge_inputs(hq, hkv, Sq, Skv, D, 60)
    sq, skv = sq_a or Sq, skv_a or Skv
    do = _normal((1, hq, Sq, D), 63)
    do[:, :, sq:] = 0.0
    mask = "causal" if causal else None
    grads = jax.jit(jax.grad(lambda x, y, z: jnp.sum(
        j_sdpa(x, y, z, mask) * _bshd(do, sq)), argnums=(0, 1, 2)))(
        _bshd(q, sq), _bshd(k, skv), _bshd(v, skv))
    want_dq, want_dk, want_dv = (np.asarray(g).transpose(0, 2, 1, 3)
                                 for g in grads)
    tq, tk, tv, tdo = (torch.tensor(x) for x in (q, k, v, do))
    out, lse = flash_attention_bhsd_plain(tq, tk, tv, causal, sq_a, skv_a,
                                          return_lse=True)
    delta = (tdo * out).sum(-1)
    args = (tq, tk, tv, tdo, lse, delta, causal, sq_a, skv_a)
    for fn in (flash_attention_bwd_dq_plain, flash_attention_bwd_dq):
        got = fn(*args)
        assert got.shape == (1, hq, Sq, D)
        _assert_close(got[:, :, :sq], want_dq, 1e-5)
    for fn in (flash_attention_bwd_dkv_plain, flash_attention_bwd_dkv):
        dk, dv = fn(*args)
        assert dk.shape == dv.shape == (1, hkv, Skv, D)
        _assert_close(dk[:, :, :skv], want_dk, 1e-5)
        _assert_close(dv[:, :, :skv], want_dv, 1e-5)
        assert not dk[:, :, skv:].any() and not dv[:, :, skv:].any()


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


# (S, G, dtype): S=64 runs the single-panel TPU kernels, S=520 the blocked
# ones (the verify kernels are always blocked)
_CACHE_CASES = [(64, 1, "float32"), (64, 2, "bfloat16"),
                (520, 2, "float32"), (520, 1, "bfloat16")]


def _cache_inputs(S, G, dtype, seed, span=1):
    """q [B, span, Hq, D] in ``dtype``, float32 k/v [B, S, Hkv, D] and
    ragged valid, as (numpy, jnp dtype, torch dtype, atol factor)."""
    B, Hkv, D = 2, 2, 128
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    q = _normal((B, span, Hkv * G, D), seed)
    xk, xv = _normal((B, S, Hkv, D), seed + 1), _normal((B, S, Hkv, D),
                                                        seed + 2)
    valid = np.array([S - 7, S], np.int32)
    return q, xk, xv, valid, jdt, tdt


def _tol(want, dtype):
    if dtype == "float32":
        return 1e-5
    return 2.0 ** -6 * float(np.abs(np.asarray(want, np.float32)).max())


def _jgroup(q, Hkv):
    """[B, Sq, Hq, D] -> the Pallas kernels' [B, Hkv, G * Sq, D]."""
    B, Sq, Hq, D = q.shape
    return q.transpose(0, 2, 1, 3).reshape(B, Hkv, (Hq // Hkv) * Sq, D)


def _jungroup(out, Sq):
    B, Hkv, R, D = out.shape
    return (out.reshape(B, Hkv, R // Sq, Sq, D).transpose(0, 3, 1, 2, 4)
            .reshape(B, Sq, Hkv * (R // Sq), D))


def test_quantize_kv_tokens_equals_jax():
    x = _normal((2, 5, 3, 128), 40) * np.float32(3.7)
    x[0, 1, 2] = 0.0  # an all-zero row takes the 1e-8 floor
    jq, jscale = jda.quantize_kv_tokens(jnp.asarray(x))
    tq, tscale = quantize_kv_tokens(torch.tensor(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(tscale.numpy(), np.asarray(jscale))


@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("quant", [False, True])
def test_update_decode_cache_equals_jax(quant, ragged):
    """Dense and int8 caches, an int position and per-row [B] positions:
    the caches after the write equal JAX's exactly."""
    B, Hkv, S, D, S_new = 2, 2, 24, 128, 3
    xk, xv = _normal((B, S_new, Hkv, D), 41), _normal((B, S_new, Hkv, D), 42)
    pos = np.array([4, 17], np.int32) if ragged else 5
    if quant:
        jk, jv = (jda.make_quantized_kv(B, Hkv, S, D) for _ in range(2))
        tk, tv = (QuantizedKV(torch.zeros(B, Hkv, S, D, dtype=torch.int8),
                              torch.zeros(B, Hkv, S)) for _ in range(2))
    else:
        ck, cv = _normal((B, Hkv, S, D), 43), _normal((B, Hkv, S, D), 44)
        jk, jv = jnp.asarray(ck), jnp.asarray(cv)
        tk, tv = torch.tensor(ck), torch.tensor(cv)
    jk, jv = jda.update_decode_cache(
        jk, jv, jnp.asarray(xk), jnp.asarray(xv),
        jnp.asarray(pos) if ragged else pos, layout="bhsd")
    update_decode_cache(tk, tv, torch.tensor(xk), torch.tensor(xv),
                        torch.tensor(pos) if ragged else pos)
    for t, j in ((tk, jk), (tv, jv)):
        for tl, jl in zip(t if quant else (t,), j if quant else (j,)):
            np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))


@pytest.mark.parametrize("S,G,dtype", _CACHE_CASES)
def test_decode_attend_plain_matches_pallas(S, G, dtype):
    """The attend-only decode (no cache write), plain version and wrapper,
    against ``_decode_impl`` in interpret mode."""
    q, xk, xv, valid, jdt, tdt = _cache_inputs(S, G, dtype, 50)
    k, v = xk.transpose(0, 2, 1, 3), xv.transpose(0, 2, 1, 3)
    want = _jungroup(jda._decode_impl(
        _jgroup(jnp.asarray(q, jdt), 2), jnp.asarray(k, jdt),
        jnp.asarray(v, jdt), jnp.asarray(valid), interpret=True), 1)
    args = (torch.tensor(q).to(tdt), torch.tensor(k.copy()).to(tdt),
            torch.tensor(v.copy()).to(tdt), torch.tensor(valid))
    for fn in (decode_attention_plain, decode_attention):
        _assert_close(fn(*args).float(), want, _tol(want, dtype))


@pytest.mark.parametrize("S,G,dtype", _CACHE_CASES)
def test_decode_quant_plain_matches_pallas(S, G, dtype):
    """int8 cache: attend-only against ``_decode_impl_q8``; the fused
    quantize + write + attend against ``_decode_update_impl_q8``, the int8
    values and scales after the write exactly equal to the write
    ``quantize_kv_tokens`` makes."""
    q, xk, xv, valid, jdt, tdt = _cache_inputs(S, G, dtype, 60)
    B, Hkv, D = 2, 2, 128
    jkq, jks = jda.quantize_kv_tokens(jnp.asarray(xk))
    jvq, jvs = jda.quantize_kv_tokens(jnp.asarray(xv))
    jq = _jgroup(jnp.asarray(q, jdt), Hkv)
    want = _jungroup(jda._decode_impl_q8(jq, jkq, jvq, jks, jvs,
                                         jnp.asarray(valid), interpret=True),
                     1)

    def caches():
        return (QuantizedKV(*quantize_kv_tokens(torch.tensor(xk))),
                QuantizedKV(*quantize_kv_tokens(torch.tensor(xv))))

    tq, tvalid = torch.tensor(q).to(tdt), torch.tensor(valid)
    for fn in (decode_attention_quant_plain, decode_attention_quant):
        _assert_close(fn(tq, *caches(), tvalid).float(), want,
                      _tol(want, dtype))

    nk, nv = _normal((B, 1, Hkv, D), 63), _normal((B, 1, Hkv, D), 64)
    pos = np.array([3, S - 1], np.int32)
    valid = pos + 1
    o_j, k_j, v_j, ks_j, vs_j = jda._decode_update_impl_q8(
        jq, jkq, jvq, jks, jvs,
        jnp.asarray(nk, jdt).transpose(0, 2, 1, 3),
        jnp.asarray(nv, jdt).transpose(0, 2, 1, 3), jnp.asarray(pos),
        jnp.asarray(valid), interpret=True)
    want = _jungroup(o_j, 1)
    # the write as quantize_kv_tokens makes it: what the caches must equal
    rk, rv = jda._update_decode_cache_ragged(
        jda.QuantizedKV(jkq, jks), jda.QuantizedKV(jvq, jvs),
        jnp.asarray(nk, jdt), jnp.asarray(nv, jdt), jnp.asarray(pos))
    for fn in (decode_attention_update_quant_plain,
               decode_attention_update_quant):
        kq, vq = caches()
        out = fn(tq, kq, vq, torch.tensor(nk).to(tdt),
                 torch.tensor(nv).to(tdt), torch.tensor(pos),
                 torch.tensor(valid))
        _assert_close(out.float(), want, _tol(want, dtype))
        for t, j in ((kq.qv, rk.qv), (vq.qv, rv.qv), (kq.scale, rk.scale),
                     (vq.scale, rv.scale)):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        # the Pallas kernel's own scales, compiled as one program, sit
        # within an ulp of quantize_kv_tokens' (tests/test_fused_update_
        # attend.py allows the same); on bf16 tokens x / scale often lies
        # on a rounding tie, which that ulp can tip by one step
        for t, j in ((kq.scale, ks_j), (vq.scale, vs_j)):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-7,
                                       rtol=1e-6)
        for t, j in ((kq.qv, k_j), (vq.qv, v_j)):
            diff = np.abs(t.numpy().astype(np.int32) - np.asarray(j, np.int32))
            assert diff.max() <= 1 and (diff != 0).sum() <= 4


@pytest.mark.parametrize("span", [2, 5, 8, 16])
@pytest.mark.parametrize("S,G,dtype", _CACHE_CASES)
def test_verify_plain_matches_pallas(S, G, dtype, span):
    """The verify window over a dense and an int8 cache against
    ``_verify_attention_bhgd`` and ``_verify_attention_bhgd_q8`` in
    interpret mode, and against the right-aligned causal plain path."""
    q, xk, xv, valid, jdt, tdt = _cache_inputs(S, G, dtype, 70, span=span)
    Hkv = 2
    k, v = xk.transpose(0, 2, 1, 3), xv.transpose(0, 2, 1, 3)
    jq = _jgroup(jnp.asarray(q, jdt), Hkv)
    want = _jungroup(jda._verify_attention_bhgd(
        jq, jnp.asarray(k, jdt), jnp.asarray(v, jdt), jnp.asarray(valid),
        span, interpret=True), span)
    tq, tvalid = torch.tensor(q).to(tdt), torch.tensor(valid)
    tk, tv = torch.tensor(k.copy()).to(tdt), torch.tensor(v.copy()).to(tdt)
    for fn in (verify_attention_plain, verify_attention):
        _assert_close(fn(tq, tk, tv, tvalid).float(), want,
                      _tol(want, dtype))
    if dtype == "float32":
        ref = j_sdpa(jnp.asarray(q), jnp.asarray(xk), jnp.asarray(xv),
                     "causal", jnp.asarray(valid))
        _assert_close(verify_attention_plain(tq, tk, tv, tvalid), ref, 1e-5)

    jkq, jks = jda.quantize_kv_tokens(jnp.asarray(xk))
    jvq, jvs = jda.quantize_kv_tokens(jnp.asarray(xv))
    want = _jungroup(jda._verify_attention_bhgd_q8(
        jq, jkq, jvq, jks, jvs, jnp.asarray(valid), span, interpret=True),
        span)
    kq = QuantizedKV(*quantize_kv_tokens(torch.tensor(xk)))
    vq = QuantizedKV(*quantize_kv_tokens(torch.tensor(xv)))
    for fn in (verify_attention_quant_plain, verify_attention_quant):
        _assert_close(fn(tq, kq, vq, tvalid).float(), want,
                      _tol(want, dtype))


# (slots: resident blocks on a 132-SM card; 2 a SM for the bf16 kernel at
# R <= 32, 3 for the int8 one, 1 and 2 at R = 64)
@pytest.mark.parametrize("B,Hkv,R,S,slots,want", [
    (1, 40, 8, 1544, 264, 5), (1, 40, 8, 1544, 396, 9),
    (4, 40, 16, 1544, 264, 1), (4, 40, 16, 1544, 396, 2),
    (1, 40, 16, 1544, 264, 5), (4, 8, 80, 1544, 132, 2),
    (4, 8, 80, 1544, 264, 4), (1, 8, 128, 1000, 132, 8),
    (2, 2, 10, 520, 264, 9), (64, 40, 8, 1544, 396, 1),
    (1, 1, 200, 60, 132, 1)])
def test_verify_splits(B, Hkv, R, S, slots, want):
    """The verify kernel's split count: the most runs of whole 64-key
    tiles whose blocks still fit the card in one wave, at least one; no
    split empty, every tile in one."""
    P = dec.verify_splits(B, Hkv, R, S, slots)
    assert P == want
    tiles = -(-S // 64)
    per = -(-tiles // P)
    assert (P - 1) * per < tiles <= P * per


# (slots: resident blocks of the decode kernel on a 132-SM card; 3 a SM at
# one query row a kv head, 2 at eight). Head dim 128 over the bf16 cache
# (stages of 32 rows), then falcon's head dim 64 at G 29 (four blocks a kv
# head): stages of 64 bf16 or 128 int8 rows, its 80-row cache below two
# int8 stages.
@pytest.mark.parametrize("B,Hkv,G,S,slots,quant,D,want", [
    (1, 40, 1, 1544, 396, False, 128, 8), (2, 40, 1, 1544, 396, False, 128, 4),
    (4, 40, 1, 1544, 396, False, 128, 2), (4, 40, 1, 1544, 264, False, 128, 1),
    (8, 40, 1, 512, 396, False, 128, 1), (64, 40, 1, 1544, 396, False, 128, 1),
    (1, 40, 1, 1544, 132, False, 128, 2), (1, 40, 1, 300, 396, False, 128, 4),
    (1, 8, 5, 1544, 264, False, 128, 8), (4, 8, 5, 1544, 264, False, 128, 8),
    (4, 8, 8, 1000, 264, False, 128, 8), (2, 8, 1, 60, 396, False, 128, 1),
    (1, 2, 20, 200, 264, False, 128, 4), (1, 40, 1, 300, 396, True, 128, 4),
    (1, 8, 29, 80, 264, False, 64, 2), (1, 8, 29, 80, 264, True, 64, 1),
    (1, 8, 29, 200, 264, True, 64, 2), (4, 8, 29, 2048, 264, True, 64, 2),
    (1, 1, 232, 1001, 264, True, 64, 8)])
def test_decode_splits(B, Hkv, G, S, slots, quant, D, want):
    """The decode kernel's cluster size: the largest power of two up to 8
    whose blocks (one a batch row, kv head and group of 8 query rows, per
    cluster rank) still fit the card in one wave, with at least 64 cache
    rows and one whole stage a block; one when even a single block each
    overfills the card."""
    C = dec.decode_splits(B, Hkv, G, S, slots, quant, D)
    assert C == want
    assert C & (C - 1) == 0 and 1 <= C <= dec.DECODE_MAX_CLUSTER
    blocks = B * Hkv * -(-G // 8)
    assert C == 1 or blocks * C <= slots
    floor = max(64, dec.decode_stage_rows(quant, D))
    assert C == 1 or floor * (C - 1) < S


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
               vit_attention, decode_attention, decode_attention_quant,
               decode_attention_update_quant, verify_attention,
               verify_attention_quant)
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
    q1, q2 = torch.zeros(1, 1, 2, 128), torch.zeros(1, 2, 2, 128)
    c = torch.zeros(1, 2, 8, 128)
    valid, pos = torch.tensor([4]), torch.tensor([3])
    decode_attention(q1, c, c, valid)
    verify_attention(q2, c, c, valid)
    kq = QuantizedKV(torch.zeros(1, 2, 8, 128, dtype=torch.int8),
                     torch.ones(1, 2, 8))
    decode_attention_quant(q1, kq, kq, valid)
    decode_attention_update_quant(q1, kq, kq, q1, q1, pos, valid)
    verify_attention_quant(q2, kq, kq, valid)
    after = [f.launches for f in counted]
    assert before == after


# Clusters of 1-8 blocks of the int4 GEMV that an H100 (132 SMs in GPCs of
# 16-18) holds at once, from cudaOccupancyMaxActiveClusters on the card at
# three, two and one blocks an SM (v1 up to 8 rows, up to 24, above; v3 up
# to 8 rows, above: three sets of sums a thread).
_CAP_3 = (396, 198, 124, 92, 69, 62, 47, 45)
_CAP_2 = (264, 132, 79, 62, 47, 39, 32, 30)
_CAP_1 = (132, 66, 39, 30, 22, 17, 15, 15)


def _gemv_cap(mode, M):
    if mode == "v3":
        return _CAP_2 if M <= 8 else _CAP_1
    return _CAP_3 if M <= 8 else _CAP_2 if M <= 24 else _CAP_1


# The cluster size at the decoder linears (K padded, N) and M 1, 4, 9 and
# 32; want at three, two and one blocks an SM.
@pytest.mark.parametrize("mode", ["v1", "v3"])
@pytest.mark.parametrize("M", [1, 4, 9, 32])
@pytest.mark.parametrize("K,N,want", [
    (5120, 5120, (8, 5, 2)), (5120, 13824, (3, 2, 1)),
    (14336, 5120, (8, 5, 2)), (5120, 32000, (1, 1, 1))])
def test_gemv_splits_main_path(mode, M, K, N, want):
    """Every column tile gets its cluster in one wave: at two blocks an SM
    the 40 tiles of the square linears take 5 blocks each (the card holds
    47 clusters of 5 but only 39 of 6), w1/w3's 108 take 2, the head's 250
    take 1."""
    cap = _gemv_cap(mode, M)
    C = qmm.gemv_splits(N, K // 2, 64, cap)
    assert C == want[(_CAP_3, _CAP_2, _CAP_1).index(cap)]
    assert C == 1 or cap[C - 1] >= -(-N // qmm.GEMV_BN)


# (N, K/2, group, capacity, want): small N (one or ten column tiles), a card
# that holds few clusters, few runs of stages (a rank may get none: fewer
# blocks), groups that span stages (128) or whose run is 3 stages (48)
_FEW = (30, 15, 10, 7, 6, 5, 4, 3)


@pytest.mark.parametrize("N,half,group,cap,want", [
    (64, 48, 16, _CAP_2, 1), (1200, 2560, 64, _CAP_2, 8),
    (5120, 2560, 64, _FEW, 1), (13824, 2560, 64, _CAP_1, 1),
    (128, 640, 64, _CAP_2, 5), (5120, 2560, 128, _CAP_2, 5),
    (48, 96, 48, _CAP_2, 1), (128, 1920, 48, _CAP_2, 5),
    (128, 50, 2, _CAP_2, 1), (1200, 2560, 64, _FEW, 3)])
def test_gemv_splits(N, half, group, cap, want):
    """The largest cluster, up to 8, of which the card holds one for every
    column tile at once, with a run of whole groups of stages for every
    rank."""
    C = qmm.gemv_splits(N, half, group, cap)
    assert C == want
    assert 1 <= C <= qmm.GEMV_MAX_CLUSTER
    assert C == 1 or cap[C - 1] >= -(-N // qmm.GEMV_BN)
    runs = qmm._gemv_runs(half, group)
    assert -(-runs // C) * (C - 1) < runs


@pytest.mark.parametrize("half", [48, 50, 3])
def test_gemv_rows_pad(half):
    """The GEMV reads x's two halves through strides of 16 bytes: where
    K/2 % 8 != 0 it gets a copy with each half zero-padded to a multiple of
    8, the values in place."""
    x = torch.randn(5, 2 * half).to(torch.bfloat16)
    xr, xld = qmm._gemv_rows(x, half)
    assert xld % 8 == 0 and xld >= half and xld - half < 8
    if half % 8 == 0:
        assert xr is x
    v = xr.view(5, 2, xld)
    assert torch.equal(v[:, :, :half].reshape(5, 2 * half), x)
    assert not v[:, :, half:].any()
