"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, in bf16, at the shapes the llama_ens5 main path gives them.
Marked ``cuda``; skipped where no NVIDIA GPU is present. On a machine with
the card and without JAX (``tests/conftest.py`` imports it):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: both sides accumulate in f32 and round once to bf16, so they
may differ by one bf16 ulp (2^-8 relative each way); rtol 2^-6 leaves a
factor 2, and atol (1e-3 of the largest output) covers outputs that cancel
to near zero. The flash forward on the short rows of the tile-edge cases
adds the rounding of its softmax weights (``_check_flash``)."""

import pytest
import torch

from a3vlm_tpu_torch.ops import decode_attention as dec
from a3vlm_tpu_torch.ops.decode_attention import (
    QuantizedKV,
    decode_attention_update,
    decode_attention_update_plain,
    quantize_kv_tokens,
)
from a3vlm_tpu_torch.ops import flash_attention as fa
from a3vlm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
)
from a3vlm_tpu_torch.ops import quant_matmul as qmm
from a3vlm_tpu_torch.ops.quant_matmul import int4_matmul, int4_matmul_2d
from a3vlm_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
)
from a3vlm_tpu_torch.quant import _quantize_leaf_int4, _quantize_leaf_int8

pytestmark = pytest.mark.cuda
RTOL = 2.0 ** -6


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(*shape, gen):
    return torch.randn(*shape, generator=gen, device="cuda").to(torch.bfloat16)


def _check(got, want):
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    bound = RTOL * want.abs() + 1e-3 * want.abs().max()
    assert bool(((got - want).abs() <= bound).all()), float(
        (got - want).abs().max())


@pytest.mark.parametrize("M", [4, 4 * 1487])
@pytest.mark.parametrize("K,N", [(5120, 5120), (5120, 13824), (13824, 5120),
                                 (5120, 32000)])
def test_int4_matmul_cuda(gen, M, K, N):
    w = (torch.rand(K, N, generator=gen, device="cuda") * 2 - 1) / K ** 0.5
    qw = _quantize_leaf_int4(w.to(torch.bfloat16))
    x = _randn(M, K, gen=gen)
    before = int4_matmul_2d.launches
    got = int4_matmul(x, qw)
    assert int4_matmul_2d.launches == before + 1
    _check(got, int4_matmul(x, qw, impl="plain"))


def _check_flash(got, want, v, causal, sq_a, skv_a):
    """K2 on short rows. The kernel rounds the softmax weights to bf16
    before the value product, as the TPU kernel does, and the plain version
    keeps them in f32. Each weight moves by at most 2^-9 of itself and a
    row's weights sum to 1, so an output moves by at most 2^-9 max|v|, and
    by about 2^-9 max|v| / sqrt(n) where the row sees n keys of similar
    weight. So a row gets 2^-8 max|v| / sqrt(n) on top of ``_check``'s
    bound: a factor 2 over the worst case up to 4 keys, and nothing to
    speak of at the main path's lengths, which hold ``_check`` as it is."""
    got, want = got.float(), want.float()
    assert torch.isfinite(got).all()
    Sq, Skv = got.shape[2], v.shape[2]
    seen = fa._visible(Sq, Skv, causal, sq_a or Sq, skv_a or Skv,
                       got.device).sum(-1).clamp(min=1)
    bound = (RTOL * want.abs() + 1e-3 * want.abs().max()
             + 2.0 ** -8 * float(v.float().abs().max())
             * seen.float().rsqrt()[:, None])
    assert bool(((got - want).abs() <= bound).all()), float(
        (got - want).abs().max())


@pytest.mark.parametrize("B", [4, 1])
@pytest.mark.parametrize("hq,hkv,sq,skv", [(40, 40, 1487, 1487),
                                           (40, 8, 1487, 1487),
                                           (40, 40, 512, 1487)])
def test_flash_attention_cuda(gen, hq, hkv, sq, skv, B):
    q = _randn(B, hq, sq, 128, gen=gen)
    k = _randn(B, hkv, skv, 128, gen=gen)
    v = _randn(B, hkv, skv, 128, gen=gen)
    _check(flash_attention_bhsd(q, k, v, causal=True),
           flash_attention_bhsd_plain(q, k, v, causal=True))


# The edges of the tensor-core tiles (128 keys in the forward kernel, 64 in
# the dq kernel; 64 query rows to a warpgroup, 128 to a forward block):
# lengths on both sides of a tile, fewer queries than keys, GQA groups,
# head dims 32 / 64 / 96 / 128 and two that are no multiple of 8 (the slow
# load path), no mask, ragged actual lengths, and more rows than keys (rows that
# see no key: zeros and lse = -inf).
# hq, hkv, Sq, Skv, D, causal, sq_actual, skv_actual
_EDGE_CASES = [
    (2, 2, 63, 63, 128, True, None, None),
    (2, 2, 64, 64, 64, True, None, None),
    (2, 2, 65, 65, 96, True, None, None),
    (4, 4, 127, 127, 128, True, None, None),
    (4, 4, 129, 129, 64, True, None, None),
    (5, 1, 63, 129, 128, True, None, None),
    (10, 2, 127, 65, 96, True, None, None),
    (2, 2, 129, 127, 128, False, None, None),
    (5, 1, 65, 64, 64, False, None, None),
    (4, 4, 100, 100, 32, True, None, None),
    (2, 2, 65, 65, 100, True, None, None),
    (2, 1, 150, 150, 36, False, None, None),
    (2, 2, 192, 256, 128, True, 150, 200),
    (2, 2, 256, 192, 128, True, 129, 63),
    (2, 2, 128, 128, 64, False, 127, 70),
]


@pytest.mark.parametrize("hq,hkv,Sq,Skv,D,causal,sq_a,skv_a", _EDGE_CASES)
def test_flash_attention_edges_cuda(gen, hq, hkv, Sq, Skv, D, causal, sq_a,
                                    skv_a):
    """K2 at the tile edges, output and lse; a row that sees no key gives
    zeros and lse = -inf, and nothing is NaN; two launches on the same
    inputs agree bit for bit."""
    q = _randn(2, hq, Sq, D, gen=gen)
    k, v = _randn(2, hkv, Skv, D, gen=gen), _randn(2, hkv, Skv, D, gen=gen)
    out, lse = flash_attention_bhsd(q, k, v, causal, sq_a, skv_a,
                                    return_lse=True)
    want, want_lse = flash_attention_bhsd_plain(q, k, v, causal, sq_a, skv_a,
                                                return_lse=True)
    _check_flash(out, want, v, causal, sq_a, skv_a)
    empty = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), empty)
    assert not torch.isnan(lse).any()
    assert float(out[empty].abs().max() if empty.any() else 0.0) == 0.0
    assert (lse[~empty] - want_lse[~empty]).abs().max() < 1e-4
    again = flash_attention_bhsd(q, k, v, causal, sq_a, skv_a)
    assert torch.equal(out, again)


@pytest.mark.parametrize("hq,hkv,Sq,Skv,D,causal,sq_a,skv_a", _EDGE_CASES)
def test_flash_bwd_dq_edges_cuda(gen, hq, hkv, Sq, Skv, D, causal, sq_a,
                                 skv_a):
    """K9a at the tile edges on the plain forward's output and lse: a row
    that sees no key gets a zero dq, and two launches on the same inputs
    agree bit for bit (no atomics)."""
    q, do = _randn(2, hq, Sq, D, gen=gen), _randn(2, hq, Sq, D, gen=gen)
    k, v = _randn(2, hkv, Skv, D, gen=gen), _randn(2, hkv, Skv, D, gen=gen)
    out, lse = flash_attention_bhsd_plain(q, k, v, causal, sq_a, skv_a,
                                          return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, sq_a, skv_a)
    before = flash_attention_bwd_dq.launches
    got = flash_attention_bwd_dq(*args)
    assert flash_attention_bwd_dq.launches == before + 1
    _check(got, flash_attention_bwd_dq_plain(*args))
    empty = torch.isinf(lse)
    assert float(got[empty].abs().max() if empty.any() else 0.0) == 0.0
    assert torch.equal(got, flash_attention_bwd_dq(*args))


def test_decode_attention_cuda(gen):
    B, Hkv, G, S, D = 4, 40, 1, 1544, 128
    q = _randn(B, Hkv, G, D, gen=gen)
    ck, cv = _randn(B, Hkv, S, D, gen=gen), _randn(B, Hkv, S, D, gen=gen)
    nk, nv = _randn(B, Hkv, D, gen=gen), _randn(B, Hkv, D, gen=gen)
    pos = torch.tensor([1486, 1500, 1523, 1538], dtype=torch.int32,
                       device="cuda")
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    _check(decode_attention_update(q, k1, v1, nk, nv, pos, pos + 1),
           decode_attention_update_plain(q, k2, v2, nk, nv, pos, pos + 1))
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    changed = (k1 != ck).any(-1) | (v1 != cv).any(-1)
    expect = torch.zeros_like(changed)
    expect[torch.arange(B), :, pos.long()] = True
    assert not bool((changed & ~expect).any())


_CACHE_SHAPES = [(1, 40, 1, 1544), (4, 8, 5, 1544), (2, 40, 1, 1000)]


def _cache_case(gen, B, Hkv, G, S, span=1):
    """q [B, span, Hq, D], dense caches, this step's k/v, ragged pos."""
    D = 128
    q = _randn(B, span, Hkv * G, D, gen=gen)
    ck, cv = _randn(B, Hkv, S, D, gen=gen), _randn(B, Hkv, S, D, gen=gen)
    xk, xv = _randn(B, 1, Hkv, D, gen=gen), _randn(B, 1, Hkv, D, gen=gen)
    pos = torch.randint(S - 64, S, (B,), generator=gen,
                        device="cuda").to(torch.int32)
    return q, ck, cv, xk, xv, pos


def _quantized(ck, cv):
    return (QuantizedKV(*quantize_kv_tokens(ck.transpose(1, 2))),
            QuantizedKV(*quantize_kv_tokens(cv.transpose(1, 2))))


@pytest.mark.parametrize("B,Hkv,G,S", _CACHE_SHAPES)
def test_decode_attend_only_cuda(gen, B, Hkv, G, S):
    """The attend-only kernel agrees with its plain version and, on a cache
    the fused kernel has written, equals the fused kernel's output bit for
    bit."""
    q, ck, cv, xk, xv, pos = _cache_case(gen, B, Hkv, G, S)
    D = 128
    fused = decode_attention_update(
        q.reshape(B, Hkv, G, D), ck, cv, xk.reshape(B, Hkv, D),
        xv.reshape(B, Hkv, D), pos, pos + 1)
    got = dec.decode_attention(q, ck, cv, pos + 1)
    assert torch.equal(got.reshape(B, Hkv, G, D), fused)
    _check(got, dec.decode_attention_plain(q, ck, cv, pos + 1))


@pytest.mark.parametrize("B,Hkv,G,S", _CACHE_SHAPES)
def test_decode_attention_int8_cuda(gen, B, Hkv, G, S):
    """The int8 kernels: attend-only against its plain version; the fused
    form's output, int8 rows and scales against the plain version's, the
    caches bit for bit, rows other than pos untouched."""
    q, ck, cv, xk, xv, pos = _cache_case(gen, B, Hkv, G, S)
    kq, vq = _quantized(ck, cv)
    _check(dec.decode_attention_quant(q, kq, vq, pos + 1),
           dec.decode_attention_quant_plain(q, kq, vq, pos + 1))
    k1, v1, k2, v2 = (QuantizedKV(c.qv.clone(), c.scale.clone())
                      for c in (kq, vq, kq, vq))
    _check(dec.decode_attention_update_quant(q, k1, v1, xk, xv, pos, pos + 1),
           dec.decode_attention_update_quant_plain(q, k2, v2, xk, xv, pos,
                                                   pos + 1))
    for a, b in zip((*k1, *v1), (*k2, *v2)):
        assert torch.equal(a, b)
    changed = (k1.qv != kq.qv).any(-1) | (k1.scale != kq.scale)
    expect = torch.zeros_like(changed)
    expect[torch.arange(B), :, pos.long()] = True
    assert not bool((changed & ~expect).any())


@pytest.mark.parametrize("span", [2, 8, 16])
@pytest.mark.parametrize("B,Hkv,G,S", _CACHE_SHAPES)
def test_verify_attention_cuda(gen, B, Hkv, G, S, span):
    """The verify kernels over the dense and the int8 cache; one row of the
    batch has fewer valid rows than the window, so its first query rows see
    no key and must give zeros."""
    q, ck, cv, _, _, pos = _cache_case(gen, B, Hkv, G, S, span=span)
    valid = pos + 1
    valid[-1] = span - 1
    got = dec.verify_attention(q, ck, cv, valid)
    _check(got, dec.verify_attention_plain(q, ck, cv, valid))
    assert float(got[-1, 0].abs().max()) == 0.0
    kq, vq = _quantized(ck, cv)
    _check(dec.verify_attention_quant(q, kq, vq, valid),
           dec.verify_attention_quant_plain(q, kq, vq, valid))


def test_cache_dispatch_routes_cuda(gen):
    """``attend_decode_cache`` on the card takes the kernels: the counts of
    the verify and decode wrappers move, and a float32 query takes the
    plain path."""
    q, ck, cv, _, _, pos = _cache_case(gen, 2, 8, 5, 520, span=4)
    names = ("verify_attention", "verify_attention_quant",
             "decode_attention", "decode_attention_quant")
    before = [getattr(dec, n).launches for n in names]
    kq, vq = _quantized(ck, cv)
    for k, v in ((ck, cv), (kq, vq)):
        dec.attend_decode_cache(q, k, v, mask="causal", kv_valid_len=pos + 1)
        dec.attend_decode_cache(q[:, :1], k, v, mask=None,
                                kv_valid_len=pos + 1)
    assert [getattr(dec, n).launches for n in names] == [b + 1
                                                         for b in before]
    dec.attend_decode_cache(q.float(), ck, cv, mask="causal",
                            kv_valid_len=pos + 1)
    assert [getattr(dec, n).launches for n in names] == [b + 1
                                                         for b in before]


@pytest.mark.parametrize("H,D", [(16, 64), (16, 88), (24, 64)])
def test_vit_attention_cuda(gen, H, D):
    q, k, v = (_randn(20, 257, H, D, gen=gen) for _ in range(3))
    _check(vit_attention(q, k, v), vit_attention_plain(q, k, v))


# hq, hkv, sq, skv, D: equal, GQA, right-aligned unequal, more rows than
# keys (rows with no visible key), ragged lengths, head dims 64 and 88, and
# the training shape of one sample
_BWD_CASES = [(4, 4, 256, 256, 128), (8, 2, 300, 300, 128),
              (4, 4, 100, 333, 64), (4, 2, 200, 77, 88), (2, 1, 45, 45, 128),
              (40, 40, 2048, 2048, 128)]


@pytest.mark.parametrize("hq,hkv,sq,skv,D", _BWD_CASES)
def test_flash_lse_and_backward_kernels_cuda(gen, hq, hkv, sq, skv, D):
    """K2's lse and K9a/K9b against their plain versions on the same
    inputs (the kernel's output and lse feed both backward sides)."""
    q = _randn(2, hq, sq, D, gen=gen)
    k = _randn(2, hkv, skv, D, gen=gen)
    v = _randn(2, hkv, skv, D, gen=gen)
    do = _randn(2, hq, sq, D, gen=gen)
    out, lse = flash_attention_bhsd(q, k, v, causal=True, return_lse=True)
    want_out, want_lse = flash_attention_bhsd_plain(q, k, v, True,
                                                    return_lse=True)
    _check(out, want_out)
    empty = torch.isinf(want_lse)
    assert torch.equal(torch.isinf(lse), empty)
    assert (lse[~empty] - want_lse[~empty]).abs().max() < 1e-4
    before = (flash_attention_bwd_dq.launches,
              flash_attention_bwd_dkv.launches)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    assert (flash_attention_bwd_dq.launches,
            flash_attention_bwd_dkv.launches) == (before[0] + 1,
                                                  before[1] + 1)
    want = flash_attention_bwd_plain(q, k, v, out, lse, do, causal=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == torch.bfloat16
        _check(g, w)


def test_flash_attention_function_grads_cuda(gen):
    """FlashAttention's gradients against autograd through the plain
    forward. The kernels round p and ds to bf16 before their products and
    autograd does not, which adds about one bf16 ulp per term; the bound is
    4x the kernel-twin one for that."""
    B, S, Hq, Hkv, D = 2, 200, 8, 2, 128
    q, k, v = (_randn(B, S, h, D, gen=gen).requires_grad_()
               for h in (Hq, Hkv, Hkv))
    w = _randn(B, S, Hq, D, gen=gen)
    got = torch.autograd.grad((flash_attention(q, k, v) * w).float().sum(),
                              (q, k, v))
    ref = flash_attention_bhsd_plain(q.transpose(1, 2), k.transpose(1, 2),
                                     v.transpose(1, 2)).transpose(1, 2)
    want = torch.autograd.grad((ref * w).float().sum(), (q, k, v))
    for g, r in zip(got, want):
        g, r = g.float(), r.float()
        bound = 4 * (RTOL * r.abs() + 1e-3 * r.abs().max())
        assert bool(((g - r).abs() <= bound).all()), float(
            (g - r).abs().max())


# The quantized-matmul kernels over the edge shapes: M on both sides of the
# GEMV limit (32) and of the W8A8 prefill threshold (256), an N that is no
# multiple of a tile (16 * 75 = 1200), K 13824 unpadded for the int8
# kernel and padded to 14336 for the int4 ones.
_EDGE_MS = [1, 32, 33, 255, 256, 257]
_EDGE_KN = [(5120, 1200), (13824, 5120)]


def _weight(K, N, gen):
    w = (torch.rand(K, N, generator=gen, device="cuda") * 2 - 1) / K ** 0.5
    return w.to(torch.bfloat16)


def _padded(x, qw):
    kpad = qw.q.shape[0] * 2
    return torch.nn.functional.pad(x, (0, kpad - x.shape[1])).contiguous()


@pytest.mark.parametrize("M", _EDGE_MS)
@pytest.mark.parametrize("K,N", _EDGE_KN)
def test_int8_matmul_cuda(gen, M, K, N):
    qw = _quantize_leaf_int8(_weight(K, N, gen))
    x = _randn(M, K, gen=gen)
    before = qmm.int8_matmul_2d.launches
    got = qmm.int8_matmul(x, qw)
    assert qmm.int8_matmul_2d.launches == before + 1
    _check(got, qmm.int8_matmul(x, qw, impl="plain"))


@pytest.mark.parametrize("M", _EDGE_MS)
@pytest.mark.parametrize("K,N", _EDGE_KN)
def test_int4_v3_cuda(gen, M, K, N):
    qw = _quantize_leaf_int4(_weight(K, N, gen))
    x = _randn(M, K, gen=gen)
    before = (qmm.int4_matmul_2d_v3.launches, int4_matmul_2d.launches)
    got = int4_matmul(x, qw, variant="v3")
    assert (qmm.int4_matmul_2d_v3.launches, int4_matmul_2d.launches) == (
        before[0] + 1, before[1])
    _check(got, int4_matmul(x, qw, impl="plain", variant="v3"))


@pytest.mark.parametrize("M", _EDGE_MS)
@pytest.mark.parametrize("K,N", _EDGE_KN)
def test_int4_glu_cuda(gen, M, K, N):
    qw = _quantize_leaf_int4(_weight(K, N, gen))
    g, u = _randn(M, K, gen=gen), _randn(M, K, gen=gen)
    res = _randn(M, N, gen=gen)
    before = qmm.int4_matmul_2d_glu.launches
    got = qmm.int4_ffn_down(g, u, qw, res)
    assert qmm.int4_matmul_2d_glu.launches == before + 1
    _check(got, qmm.int4_ffn_down(g, u, qw, res, impl="plain"))


@pytest.mark.parametrize("M", [1, 8, 32])
@pytest.mark.parametrize("K,N", _EDGE_KN)
def test_int4_w4a8_cuda(gen, M, K, N):
    qw = _quantize_leaf_int4(_weight(K, N, gen))
    x = _padded(_randn(M, K, gen=gen), qw)
    before = qmm.int4_matmul_2d_w4a8.launches
    got = qmm.int4_matmul_2d_w4a8(x, qw.q, qw.scale, qw.group)
    assert qmm.int4_matmul_2d_w4a8.launches == before + 1
    _check(got, qmm.int4_matmul_2d_w4a8_plain(x, qw.q, qw.scale, qw.group))
    with pytest.raises(ValueError):
        qmm.int4_matmul_2d_w4a8(_padded(_randn(33, K, gen=gen), qw), qw.q,
                                qw.scale, qw.group)


@pytest.mark.parametrize("M", [33, 255, 256, 257, 1487])
@pytest.mark.parametrize("K,N", _EDGE_KN)
def test_int4_w8a8p_cuda_bit_identical(gen, M, K, N):
    """Integer sums are exact and the epilogue has one order of products:
    the kernel equals its plain version bit for bit."""
    qw = _quantize_leaf_int4(_weight(K, N, gen))
    x = _padded(_randn(M, K, gen=gen), qw)
    before = qmm.int4_matmul_2d_w8a8p.launches
    got = qmm.int4_matmul_2d_w8a8p(x, qw.q, qw.scale, qw.group)
    assert qmm.int4_matmul_2d_w8a8p.launches == before + 1
    want = qmm.int4_matmul_2d_w8a8p_plain(x, qw.q, qw.scale, qw.group)
    assert torch.equal(got, want), int((got != want).sum())


def test_quant_flags_route_on_cuda(gen, monkeypatch):
    """The dispatcher on the card: each flag sends its range of M to its
    kernel, and the flags off leave the exact kernel."""
    qw = _quantize_leaf_int4(_weight(5120, 5120, gen))
    small, large = _randn(4, 5120, gen=gen), _randn(300, 5120, gen=gen)
    monkeypatch.setattr(qmm, "W4A8_DECODE", True)
    monkeypatch.setattr(qmm, "W8A8_PREFILL", True)
    names = ("int4_matmul_2d", "int4_matmul_2d_w4a8", "int4_matmul_2d_w8a8p")
    before = [getattr(qmm, n).launches for n in names]
    int4_matmul(small, qw)
    int4_matmul(large, qw)
    int4_matmul(_randn(100, 5120, gen=gen), qw)
    after = [getattr(qmm, n).launches for n in names]
    assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
