"""The hand-written CUDA kernels against their plain PyTorch versions on
the card, in bf16, at the shapes the llama_ens5 main path gives them.
Marked ``cuda``; skipped where no NVIDIA GPU is present. On a machine with
the card and without JAX (``tests/conftest.py`` imports it):

    python -m pytest --noconftest tests/test_torch_kernels_cuda.py -q

Tolerance: both sides accumulate in f32 and round once to bf16, so they
may differ by one bf16 ulp (2^-8 relative each way); rtol 2^-6 leaves a
factor 2, and atol (1e-3 of the largest output) covers outputs that cancel
to near zero."""

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
    flash_attention_bwd_dkv_plain,
    flash_attention_bwd_dq,
    flash_attention_bwd_dq_plain,
    flash_attention_bwd_plain,
)
from a3vlm_tpu_torch.ops import _kernels
from a3vlm_tpu_torch.ops import quant_matmul as qmm
from a3vlm_tpu_torch.ops.quant_matmul import int4_matmul, int4_matmul_2d
from a3vlm_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
)
from a3vlm_tpu_torch.quant import (
    QuantizedWeight,
    _quantize_leaf_int4,
    _quantize_leaf_int8,
)

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


# The decoder linears of the 13B model (K, N) at decode, one request's
# prefill, the QLoRA step's M (2 x 2048) and four requests' prefill, then
# the tiled route's edges (_EDGE_MS x _EDGE_KN, below); a relaunch on the
# same inputs must give the same bits.
@pytest.mark.parametrize("M,K,N", [
    (M, K, N) for M in (4, 1487, 4096, 4 * 1487)
    for K, N in ((5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000))
] + [(M, K, N) for M in (33, 127, 128, 129, 255, 256, 257)
     for K, N in ((5120, 1200), (13824, 5120))])
def test_int4_matmul_cuda(gen, M, K, N):
    w = (torch.rand(K, N, generator=gen, device="cuda") * 2 - 1) / K ** 0.5
    qw = _quantize_leaf_int4(w.to(torch.bfloat16))
    x = _randn(M, K, gen=gen)
    before = int4_matmul_2d.launches
    got = int4_matmul(x, qw)
    assert int4_matmul_2d.launches == before + 1
    _check(got, int4_matmul(x, qw, impl="plain"))
    assert torch.equal(got, int4_matmul(x, qw))


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


@pytest.mark.parametrize("seed", range(16))
def test_flash_attention_chunk_cuda(gen, seed):
    """K2 at a chunk of the chunked prefill (B1, 476 queries against 1500
    keys) on samples of their own, held to ``_check``'s plain bound, and a
    relaunch gives the same bits. With the softmax weights in bf16 alone,
    one to four near-zero outputs left that bound on seeds 7, 12 and 15
    here (12 of seeds 0-63 in scripts/torch_flash_chunk_seeds.py); the
    kernel now carries them as a high and a low part."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = _randn(1, 40, 476, 128, gen=g)
    k, v = _randn(1, 40, 1500, 128, gen=g), _randn(1, 40, 1500, 128, gen=g)
    got = flash_attention_bhsd(q, k, v, causal=True)
    _check(got, flash_attention_bhsd_plain(q, k, v, causal=True))
    assert torch.equal(got, flash_attention_bhsd(q, k, v, causal=True))


@pytest.mark.parametrize("B", [1, 4])
@pytest.mark.parametrize("sq", [16, 64, 128, 512])
def test_flash_attention_extension_cuda(gen, B, sq):
    """K2 at a prefix-cache admission of continuous batching: a bucket of
    question tokens right-aligned over the [BOS | image words] prefix (1456
    rows) and itself, the keys' extent passed as the cache dispatch passes
    it; a relaunch gives the same bits."""
    skv = 1456 + sq
    q = _randn(B, 40, sq, 128, gen=gen)
    k, v = _randn(B, 40, skv, 128, gen=gen), _randn(B, 40, skv, 128, gen=gen)
    got = flash_attention_bhsd(q, k, v, causal=True, skv_actual=skv)
    _check(got, flash_attention_bhsd_plain(q, k, v, causal=True,
                                           skv_actual=skv))
    assert torch.equal(got, flash_attention_bhsd(q, k, v, causal=True,
                                                 skv_actual=skv))


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
    _check(out, want)
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


@pytest.mark.parametrize("hq,hkv,Sq,Skv,D,causal,sq_a,skv_a", _EDGE_CASES)
def test_flash_bwd_dkv_edges_cuda(gen, hq, hkv, Sq, Skv, D, causal, sq_a,
                                  skv_a):
    """K9b at the tile edges (128 keys to a block, 64 to a warpgroup, 64
    query rows to a tile) on the plain forward's output and lse: dk and dv
    against the plain version, exact zeros for keys that no row sees, and
    two launches agree bit for bit (no atomics)."""
    q, do = _randn(2, hq, Sq, D, gen=gen), _randn(2, hq, Sq, D, gen=gen)
    k, v = _randn(2, hkv, Skv, D, gen=gen), _randn(2, hkv, Skv, D, gen=gen)
    out, lse = flash_attention_bhsd_plain(q, k, v, causal, sq_a, skv_a,
                                          return_lse=True)
    delta = (do.float() * out.float()).sum(-1)
    args = (q, k, v, do, lse, delta, causal, sq_a, skv_a)
    before = flash_attention_bwd_dkv.launches
    dk, dv = flash_attention_bwd_dkv(*args)
    assert flash_attention_bwd_dkv.launches == before + 1
    want_dk, want_dv = flash_attention_bwd_dkv_plain(*args)
    _check(dk, want_dk)
    _check(dv, want_dv)
    seen = fa._visible(Sq, Skv, causal, sq_a or Sq, skv_a or Skv,
                       q.device).any(0)
    assert not dk[:, :, ~seen].any() and not dv[:, :, ~seen].any()
    again = flash_attention_bwd_dkv(*args)
    assert torch.equal(dk, again[0]) and torch.equal(dv, again[1])


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


def _cache_case(gen, B, Hkv, G, S, span=1, D=128):
    """q [B, span, Hq, D], dense caches, this step's k/v, ragged pos."""
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


def _decode_fused_and_attend(q, ck, cv, xk, xv, pos, valid):
    """Both cache kinds through the fused and the attend-only decode
    wrappers: each launches once; the fused output holds the plain
    version's bound, the caches (and scales) equal the plain version's bit
    for bit with no row but pos[b] changed; attend-only over the written
    cache gives the fused output's bits."""
    B, _, Hq, D = q.shape
    Hkv, S = ck.shape[1], ck.shape[2]
    G = Hq // Hkv
    expect = torch.zeros(B, Hkv, S, dtype=torch.bool, device="cuda")
    expect[torch.arange(B), :, pos.long()] = True
    nk, nv = xk.reshape(B, Hkv, D), xv.reshape(B, Hkv, D)

    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    before = dec.decode_attention_update.launches
    fused = decode_attention_update(q.reshape(B, Hkv, G, D), k1, v1, nk, nv,
                                    pos, valid)
    assert dec.decode_attention_update.launches == before + 1
    _check(fused, decode_attention_update_plain(q.reshape(B, Hkv, G, D), k2,
                                                v2, nk, nv, pos, valid))
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    changed = (k1 != ck).any(-1) | (v1 != cv).any(-1)
    assert not bool((changed & ~expect).any())
    before = dec.decode_attention.launches
    got = dec.decode_attention(q, k1, v1, valid)
    assert dec.decode_attention.launches == before + 1
    assert torch.equal(got.reshape(B, Hkv, G, D), fused)

    kq, vq = _quantized(ck, cv)
    k1, v1, k2, v2 = (QuantizedKV(c.qv.clone(), c.scale.clone())
                      for c in (kq, vq, kq, vq))
    before = dec.decode_attention_update_quant.launches
    fused = dec.decode_attention_update_quant(q, k1, v1, xk, xv, pos, valid)
    assert dec.decode_attention_update_quant.launches == before + 1
    _check(fused, dec.decode_attention_update_quant_plain(q, k2, v2, xk, xv,
                                                          pos, valid))
    for a, b in zip((*k1, *v1), (*k2, *v2)):
        assert torch.equal(a, b)
    changed = ((k1.qv != kq.qv).any(-1) | (k1.scale != kq.scale)
               | (v1.qv != vq.qv).any(-1) | (v1.scale != vq.scale))
    assert not bool((changed & ~expect).any())
    before = dec.decode_attention_quant.launches
    got = dec.decode_attention_quant(q, k1, v1, valid)
    assert dec.decode_attention_quant.launches == before + 1
    assert torch.equal(got, fused)


def _decode_split(quant, B, Hkv, G, S, v, D=128):
    """(cluster size, rows of a block's run at valid == v): what the card's
    rule gives the decode kernel of this cache kind and head dim."""
    C = dec.decode_splits(B, Hkv, G, S, dec._decode_slots(
        _kernels.lib(), torch.cuda.current_device(), quant, G, D), quant, D)
    rows = dec.decode_stage_rows(quant, D)
    return C, -(-(-(-v // rows)) // C) * rows


# Batch 1, 2, 4 and 8; G 1, 5 and 8; S that is no multiple of a stage (1000:
# stages of 32 bf16 or 64 int8 rows), none of 4 (1001: the int8 scales are
# read from device memory, not staged), a cache shorter than one stage (24);
# the card's largest cluster (batch 1 at Hkv 8 or 40) and its smallest
# (batch 8 at Hkv 40). ``where`` puts pos[b] on the first row of the cache,
# the first and the last row of a block's run (at valid == S - 7), the last
# visible row (the decode step's own case), the cache's last row (written,
# not seen), and on the last row of a valid shorter than one stage.
_DECODE_EDGE_SHAPES = [(1, 40, 1, 1544), (8, 40, 1, 512), (2, 8, 5, 1000),
                       (4, 8, 8, 1001), (2, 5, 8, 24), (1, 8, 1, 1001)]


def _decode_edges(gen, B, Hkv, G, S, where, D=128):
    q, ck, cv, xk, xv, _ = _cache_case(gen, B, Hkv, G, S, D=D)
    v = max(S - 7, 1)
    valid = torch.full((B,), v, dtype=torch.int32, device="cuda")
    for quant in (False, True):  # the run edges of both kinds' splits
        C, per = _decode_split(quant, B, Hkv, G, S, v, D)
        first = min(per if C > 1 else 0, v - 1)
        p = {"cache_first": 0, "run_first": first,
             "run_last": min(per - 1, v - 1), "valid_last": v - 1,
             "cache_last": S - 1, "short": min(4, S - 1)}[where]
        pos = torch.full((B,), p, dtype=torch.int32, device="cuda")
        if where == "short":
            valid = pos + 1
        _decode_fused_and_attend(q, ck, cv, xk, xv, pos, valid)


_EDGE_WHERE = ["cache_first", "run_first", "run_last", "valid_last",
               "cache_last", "short"]


@pytest.mark.parametrize("where", _EDGE_WHERE)
@pytest.mark.parametrize("B,Hkv,G,S", _DECODE_EDGE_SHAPES)
def test_decode_attention_edges_cuda(gen, B, Hkv, G, S, where):
    _decode_edges(gen, B, Hkv, G, S, where)


# The head-dim-64 instance (falcon): Falcon-180B's 232 query heads over 8
# kv heads (G 29: four blocks of rows a kv head, the last holding 5), G 1
# and 4, and multi-query (one kv head, every query head on it: G 8 and
# 232), at batch 1 and 4; stages of 64 bf16 or 128 int8 rows.
_D64_SHAPES = [(1, 8, 29, 1544), (4, 8, 29, 1001), (1, 8, 1, 1544),
               (4, 8, 4, 1000), (2, 1, 8, 1544), (4, 1, 232, 264),
               (1, 1, 232, 1001)]


@pytest.mark.parametrize("B,Hkv,G,S", _D64_SHAPES)
def test_decode_attention_d64_cuda(gen, B, Hkv, G, S):
    """Both cache kinds, fused and attend-only, at D 64 against the plain
    versions (``_decode_fused_and_attend``), ragged positions."""
    q, ck, cv, xk, xv, pos = _cache_case(gen, B, Hkv, G, S, D=64)
    _decode_fused_and_attend(q, ck, cv, xk, xv, pos, pos + 1)


# (1, 8, 29, 80): falcon's cache at batch 1, below two int8 stages of 128
# rows; (1, 8, 29, 200) between one and two.
_D64_EDGE_SHAPES = [(1, 8, 29, 1001), (2, 5, 8, 24), (8, 8, 1, 512),
                    (1, 1, 232, 1000), (1, 1, 29, 1001), (1, 8, 29, 80),
                    (1, 8, 29, 200)]


@pytest.mark.parametrize("where", _EDGE_WHERE)
@pytest.mark.parametrize("B,Hkv,G,S", _D64_EDGE_SHAPES)
def test_decode_attention_d64_edges_cuda(gen, B, Hkv, G, S, where):
    _decode_edges(gen, B, Hkv, G, S, where, D=64)


# The slot pool of continuous batching: every row of one step at its own
# position, an idle slot at position 0 with one visible row, a slot writing
# the pool's last row; the main path's pool (4 x (2048 + 9) rows, rounded
# to 2064) and a GQA one.
@pytest.mark.parametrize("pos", [[0, 17, 1030, 2063], [0, 0, 700, 2063],
                                 [2063, 1, 1486, 5]])
@pytest.mark.parametrize("B,Hkv,G,S", [(4, 40, 1, 2064), (4, 8, 5, 2064)])
def test_decode_fused_per_row_positions_cuda(gen, B, Hkv, G, S, pos):
    q, ck, cv, xk, xv, _ = _cache_case(gen, B, Hkv, G, S)
    pos = torch.tensor(pos, dtype=torch.int32, device="cuda")
    _decode_fused_and_attend(q, ck, cv, xk, xv, pos, pos + 1)


# Verify windows of the slot pool: each row's window at its own position,
# one at the start of the cache and one ending on its last row.
@pytest.mark.parametrize("span", [4, 9])
@pytest.mark.parametrize("start", [[0, 40, 1000, None], [None, 3, 0, 1456]])
def test_verify_per_row_windows_cuda(gen, span, start):
    B, Hkv, S = 4, 40, 2064
    q, ck, cv, _, _, _ = _cache_case(gen, B, Hkv, 1, S, span=span)
    start = [S - span if p is None else p for p in start]
    _verify_both(q, ck, cv, torch.tensor(start, dtype=torch.int32,
                                         device="cuda") + span)


def test_decode_cluster_sizes_cuda(gen):
    """The edge shapes above reach the rule's largest and smallest cluster
    on the card, at both head dims."""
    for quant in (False, True):
        assert (_decode_split(quant, 1, 8, 1, 1001, 1001)[0]
                == dec.DECODE_MAX_CLUSTER)
        assert _decode_split(quant, 8, 40, 1, 512, 512)[0] == 1
        assert (_decode_split(quant, 1, 1, 29, 1001, 1001, 64)[0]
                == dec.DECODE_MAX_CLUSTER)
        # falcon's short caches: no rank of a cluster without a stage
        for S in (80, 200):
            C, per = _decode_split(quant, 1, 8, 29, S, S - 7, 64)
            assert C == 1 or (C - 1) * per < S - 7, (quant, S, C, per)
    assert _decode_split(True, 1, 8, 29, 80, 73, 64)[0] == 1


@pytest.mark.parametrize("B,Hkv,G,S,D", [(1, 40, 1, 1544, 128),
                                         (4, 8, 5, 1001, 128),
                                         (2, 8, 8, 1000, 128),
                                         (4, 8, 29, 1001, 64),
                                         (2, 1, 232, 1000, 64)])
def test_decode_attention_ignores_rows_past_valid_cuda(gen, B, Hkv, G, S,
                                                      D):
    """Cache rows at or past valid[b] hold NaN (bf16) or NaN scales (int8):
    the fused and the attend-only outputs equal the plain versions' over
    the same cache with those rows zeroed, so nothing past the visible
    prefix reaches them. One row of the batch sees no key at all."""
    q, ck, cv, xk, xv, pos = _cache_case(gen, B, Hkv, G, S, D=D)
    pos = pos - 40
    valid = pos + 1
    if B > 1:
        valid[-1] = 0
    past = (torch.arange(S, device="cuda")[None, :]
            >= valid.long()[:, None])[:, None, :].expand(B, Hkv, S)
    nk, nv = xk.reshape(B, Hkv, D), xv.reshape(B, Hkv, D)
    zk = ck.masked_fill(past[..., None], 0)
    zv = cv.masked_fill(past[..., None], 0)
    nan_k = ck.masked_fill(past[..., None], float("nan"))
    nan_v = cv.masked_fill(past[..., None], float("nan"))
    want = decode_attention_update_plain(q.reshape(B, Hkv, G, D), zk.clone(),
                                         zv.clone(), nk, nv, pos, valid)
    _check(decode_attention_update(q.reshape(B, Hkv, G, D), nan_k.clone(),
                                   nan_v.clone(), nk, nv, pos, valid), want)
    _check(dec.decode_attention(q, nan_k, nan_v, valid),
           dec.decode_attention_plain(q, zk, zv, valid))
    kq, vq = _quantized(ck, cv)
    zq = [QuantizedKV(c.qv, c.scale.masked_fill(past, 0)) for c in (kq, vq)]
    nq = [QuantizedKV(c.qv, c.scale.masked_fill(past, float("nan")))
          for c in (kq, vq)]
    want = dec.decode_attention_update_quant_plain(
        q, *(QuantizedKV(c.qv.clone(), c.scale.clone()) for c in zq), xk, xv,
        pos, valid)
    _check(dec.decode_attention_update_quant(
        q, *(QuantizedKV(c.qv.clone(), c.scale.clone()) for c in nq), xk, xv,
        pos, valid), want)
    _check(dec.decode_attention_quant(q, *nq, valid),
           dec.decode_attention_quant_plain(q, *zq, valid))


def test_decode_attention_refuses_cuda(gen):
    """What the decode kernels cannot take raises on the card: a head dim
    other than 64 and 128, float32 queries, a float32 cache, float64
    scales."""
    q, ck, cv, xk, xv, pos = _cache_case(gen, 1, 8, 1, 256)
    valid = pos + 1
    kq, vq = _quantized(ck, cv)
    q96 = q[..., :96].contiguous()
    k96, v96 = ck[..., :96].contiguous(), cv[..., :96].contiguous()
    x96 = xk[..., :96].contiguous()
    calls = [
        lambda: dec.decode_attention(q96, k96, v96, valid),
        lambda: dec.decode_attention(q.float(), ck, cv, valid),
        lambda: dec.decode_attention(q, ck.float(), cv.float(), valid),
        lambda: decode_attention_update(q96.reshape(1, 8, 1, 96), k96, v96,
                                        x96.reshape(1, 8, 96),
                                        x96.reshape(1, 8, 96), pos, valid),
        lambda: decode_attention_update(q.reshape(1, 8, 1, 128).float(), ck,
                                        cv, xk.reshape(1, 8, 128),
                                        xv.reshape(1, 8, 128), pos, valid),
        lambda: dec.decode_attention_quant(q.float(), kq, vq, valid),
        lambda: dec.decode_attention_quant(
            q, QuantizedKV(kq.qv, kq.scale.double()), vq, valid),
        lambda: dec.decode_attention_quant(
            q96, QuantizedKV(kq.qv[..., :96].contiguous(), kq.scale),
            QuantizedKV(vq.qv[..., :96].contiguous(), vq.scale), valid),
        lambda: dec.decode_attention_update_quant(q, kq, vq, xk.float(),
                                                  xv.float(), pos, valid),
        lambda: dec.decode_attention_update_quant(q, kq, vq, xk, xv,
                                                  pos.long(), valid),
    ]
    for call in calls:
        with pytest.raises(ValueError):
            call()


# The verify kernels hold ``_check``'s bound on every row, short ones too:
# they carry the softmax weights as a high and a low part (~16 bits) into
# the value product, as K2 and K10 do, so they do not move rows off the
# plain versions' f32 weights as bf16 weights would.
def _verify_both(q, ck, cv, valid):
    """Both verify kernels against their plain versions: the launch
    counters move by one each, a relaunch gives the same bits, and window
    rows that see no key give zeros. Returns the two outputs."""
    kq, vq = _quantized(ck, cv)
    outs = []
    for fn, plain, k, v in (
            (dec.verify_attention, dec.verify_attention_plain, ck, cv),
            (dec.verify_attention_quant, dec.verify_attention_quant_plain,
             kq, vq)):
        before = fn.launches
        got = fn(q, k, v, valid)
        assert fn.launches == before + 1
        _check(got, plain(q, k, v, valid))
        assert torch.equal(got, fn(q, k, v, valid))
        span = q.shape[1]
        blind = (valid.long()[:, None] - span + 1
                 + torch.arange(span, device=q.device)[None, :]) <= 0
        assert not got[blind].any()
        outs.append(got)
    return outs


# The main path's caches (batch 1 and 4, 40 kv heads, S 1544), GQA with R =
# 80 (G 5, span 16), R = 128 (G 8, span 16) and R > 64 at span 9, S that is
# no multiple of 64 (1000) and none of 4 (1001: the int8 scale rows are not
# 16-byte aligned), a cache shorter than one 64-key tile (60), and R up to
# 320 (G 20: five row groups of 64).
_VERIFY_SHAPES = [(1, 40, 1, 1544), (4, 40, 1, 1544), (4, 8, 5, 1544),
                  (2, 40, 1, 1000), (2, 5, 8, 1001), (2, 8, 1, 60),
                  (1, 2, 20, 200)]


@pytest.mark.parametrize("span", [2, 3, 5, 8, 9, 16])
@pytest.mark.parametrize("B,Hkv,G,S", _VERIFY_SHAPES)
def test_verify_attention_cuda(gen, B, Hkv, G, S, span):
    """The verify kernels over the dense and the int8 cache; one row of the
    batch has fewer valid rows than the window, so its first query rows see
    no key and must give zeros."""
    q, ck, cv, _, _, pos = _cache_case(gen, B, Hkv, G, S, span=span)
    valid = pos + 1
    valid[-1] = span - 1
    _verify_both(q, ck, cv, valid)


# valid[b] just below, at and above a 64-key tile edge and a split edge.
# At Hkv 40 and S 1544 an H100 (132 SMs; two bf16 blocks resident a SM,
# three int8 ones) takes, at batch 1, 5 splits of 5 tiles (bf16, edges
# every 320 keys) and 9 of 3 (int8, every 192); at batch 4 one (bf16) and
# two of 13 (int8, the edge at 832); and the whole cache.
@pytest.mark.parametrize("span", [8, 16])
@pytest.mark.parametrize("B,valid", [
    (1, [63]), (1, [64]), (1, [65]), (1, [255]), (1, [256]), (1, [257]),
    (1, [319]), (1, [320]), (1, [321]), (1, [1544]),
    (4, [831, 832, 833, 1537]), (4, [191, 192, 193, 17])])
def test_verify_attention_edges_cuda(gen, B, valid, span):
    Hkv, S = 40, 1544
    q, ck, cv, _, _, _ = _cache_case(gen, B, Hkv, 1, S, span=span)
    _verify_both(q, ck, cv, torch.tensor(valid, dtype=torch.int32,
                                         device="cuda"))


@pytest.mark.parametrize("B,Hkv,G,S", [(1, 40, 1, 1544), (4, 8, 5, 1001)])
def test_verify_attention_ignores_rows_past_valid_cuda(gen, B, Hkv, G, S):
    """Cache rows at or past valid[b] hold NaN (bf16) or NaN scales (int8):
    the outputs equal the plain versions' over the same cache with those
    rows zeroed, so nothing past the window reaches them."""
    span = 8
    q, ck, cv, _, _, pos = _cache_case(gen, B, Hkv, G, S, span=span)
    valid = pos - 40
    past = (torch.arange(S, device="cuda")[None, :]
            >= valid.long()[:, None])[:, None, :].expand(B, Hkv, S)
    kq, vq = _quantized(ck, cv)
    zk, zv = ck.masked_fill(past[..., None], 0), cv.masked_fill(
        past[..., None], 0)
    _check(dec.verify_attention(q, ck.masked_fill(
        past[..., None], float("nan")), cv.masked_fill(
        past[..., None], float("nan")), valid),
           dec.verify_attention_plain(q, zk, zv, valid))
    nk = QuantizedKV(kq.qv, kq.scale.masked_fill(past, float("nan")))
    nv = QuantizedKV(vq.qv, vq.scale.masked_fill(past, float("nan")))
    zk = QuantizedKV(kq.qv, kq.scale.masked_fill(past, 0))
    zv = QuantizedKV(vq.qv, vq.scale.masked_fill(past, 0))
    _check(dec.verify_attention_quant(q, nk, nv, valid),
           dec.verify_attention_quant_plain(q, zk, zv, valid))


def test_verify_attention_refuses_cuda(gen):
    """What the verify kernels cannot take raises on the card: a window of
    one or 17 tokens, a head dim other than 128, float32 queries."""
    q, ck, cv, _, _, pos = _cache_case(gen, 1, 8, 1, 256, span=17)
    for bad in (q, q[:, :1], q.float()):
        with pytest.raises(ValueError):
            dec.verify_attention(bad, ck, cv, pos + 1)
    with pytest.raises(ValueError):
        dec.verify_attention(q[:, :8, :, :64].contiguous(), ck[..., :64],
                             cv[..., :64], pos + 1)


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


@pytest.mark.parametrize("seed", range(16))
def test_vit_attention_samples_cuda(gen, seed):
    """K10 at one request's widest tower (5 crops, H 24, D 64, S 257) on
    samples of their own, held to ``_check``'s plain bound. With the softmax
    weights in bf16 alone, one output that cancels near zero left that
    bound on one sample of this shape in chip_smoke's phase 3 (not on
    these 16); the kernel now carries them as a high and a low part."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    qkv = _randn(5, 257, 3 * 24 * 64, gen=g)
    q, k, v = (t.reshape(5, 257, 24, 64) for t in qkv.split(24 * 64, dim=-1))
    _check(vit_attention(q, k, v), vit_attention_plain(q, k, v))


# The edges of K10's tiles: one row, both sides of a 64-row query tile and
# of a 128-key chunk, the towers' 257 (one key past two chunks) and a
# ragged end of 44 keys; head dims 32, 64, 88 (6 k16 steps on the 128-wide
# tile), 128 and 36 (no multiple of 8: the slow load path).
@pytest.mark.parametrize("B", [5, 20])
@pytest.mark.parametrize("D", [32, 64, 88, 128, 36])
@pytest.mark.parametrize("S", [1, 63, 64, 65, 129, 257, 300])
def test_vit_attention_edges_cuda(gen, S, D, B):
    """q, k and v as the tower gives them, split views of one [B, S, 3W]
    projection read in place; against the plain version, and two launches
    agree bit for bit."""
    H = 3
    qkv = _randn(B, S, 3 * H * D, gen=gen)
    q, k, v = (t.reshape(B, S, H, D) for t in qkv.split(H * D, dim=-1))
    before = vit_attention.launches
    got = vit_attention(q, k, v)
    assert vit_attention.launches == before + 1
    assert got.shape == (B, S, H, D) and got.is_contiguous()
    _check(got, vit_attention_plain(q, k, v))
    assert torch.equal(got, vit_attention(q, k, v))


@pytest.mark.parametrize("S,D", [(1025, 64), (448, 128)])
def test_vit_attention_refuses_cuda(gen, S, D):
    """K10 refuses what it does not take, and the card stays usable: S past
    its 1024-key barriers, or K and V of one (crop, head) past a block's
    shared memory (the launch fails), and float32 (the wrapper raises)."""
    q = _randn(1, S, 1, D, gen=gen)
    with pytest.raises(RuntimeError):
        vit_attention(q, q, q)
    q = _randn(1, 257, 1, D, gen=gen)
    _check(vit_attention(q, q, q), vit_attention_plain(q, q, q))
    q = _randn(1, 8, 1, 64, gen=gen).float()
    with pytest.raises(ValueError):
        vit_attention(q, q, q)


@pytest.mark.parametrize("DP", [64, 128])
def test_wgmma_register_a_probe_cuda(gen, DP):
    """The register-A products of attention_mma.cuh (csrc/mma_probe.cu):
    A B^T with A as pack_a fragments against a K-major B, and A B with the
    fragments against an MN-major B (K2's, K9a's, K9b's and K10's form),
    each equal bit for bit to the same product with A read from shared
    memory, over three B tiles with the fragments reused; and both near the
    f32 product."""
    a = _randn(64, DP, gen=gen)
    a2 = _randn(64, 64, gen=gen)
    b = _randn(3, 64, DP, gen=gen)
    out = torch.empty(2 * 3 * 64 * 64 + 2 * 3 * 64 * DP, device="cuda")
    err = _kernels.lib().a3_probe_wgmma(
        a.data_ptr(), a2.data_ptr(), b.data_ptr(), out.data_ptr(), DP,
        _kernels.stream())
    _kernels.check(err, "a3_probe_wgmma")
    torch.cuda.synchronize()
    n = 3 * 64 * 64
    abt_ss, abt_rs = out[:n].view(3, 64, 64), out[n:2 * n].view(3, 64, 64)
    ab_ss = out[2 * n:2 * n + 3 * 64 * DP].view(3, 64, DP)
    ab_rs = out[2 * n + 3 * 64 * DP:].view(3, 64, DP)
    assert torch.equal(abt_rs, abt_ss), float((abt_rs - abt_ss).abs().max())
    assert torch.equal(ab_rs, ab_ss), float((ab_rs - ab_ss).abs().max())
    want_abt = a.float() @ b.float().transpose(1, 2)
    want_ab = a2.float() @ b.float()
    torch.testing.assert_close(abt_ss, want_abt, rtol=1e-5, atol=1e-4)
    torch.testing.assert_close(ab_ss, want_ab, rtol=1e-5, atol=1e-4)


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
# GEMV limit (32), of the tiled route's 128- and 256-row blocks and of the
# W8A8 prefill threshold (256), one request's prefill and four requests';
# an N that is no multiple of a tile (16 * 75 = 1200), K 13824 unpadded for
# the int8 kernel (and K 1000, no multiple of its 128-row step) and padded
# to 14336 for the int4 ones, and the other decoder linears. The tiled
# route's blocks are 256 rows high (two warpgroups of 128), 128 for v3; a
# relaunch on the same inputs must give the same bits (K is summed inside
# a block, no atomics).
_EDGE_MS = [1, 32, 33, 127, 128, 129, 255, 256, 257, 1487]
_EDGE_KN = [(5120, 1200), (13824, 5120)]
_TILE_CASES = ([(M, K, N) for M in _EDGE_MS for K, N in _EDGE_KN]
               + [(M, K, N) for M in (1487, 4 * 1487)
                  for K, N in ((5120, 5120), (5120, 13824), (5120, 32000))]
               + [(4 * 1487, 13824, 5120)])


def _weight(K, N, gen):
    w = (torch.rand(K, N, generator=gen, device="cuda") * 2 - 1) / K ** 0.5
    return w.to(torch.bfloat16)


def _padded(x, qw):
    kpad = qw.q.shape[0] * 2
    return torch.nn.functional.pad(x, (0, kpad - x.shape[1])).contiguous()


@pytest.mark.parametrize("M,K,N", _TILE_CASES + [(300, 1000, 1200)])
def test_int8_matmul_cuda(gen, M, K, N):
    qw = _quantize_leaf_int8(_weight(K, N, gen))
    x = _randn(M, K, gen=gen)
    before = qmm.int8_matmul_2d.launches
    got = qmm.int8_matmul(x, qw)
    assert qmm.int8_matmul_2d.launches == before + 1
    _check(got, qmm.int8_matmul(x, qw, impl="plain"))
    assert torch.equal(got, qmm.int8_matmul(x, qw))


@pytest.mark.parametrize("M,K,N", _TILE_CASES)
def test_int4_v3_cuda(gen, M, K, N):
    qw = _quantize_leaf_int4(_weight(K, N, gen))
    x = _randn(M, K, gen=gen)
    before = (qmm.int4_matmul_2d_v3.launches, int4_matmul_2d.launches)
    got = int4_matmul(x, qw, variant="v3")
    assert (qmm.int4_matmul_2d_v3.launches, int4_matmul_2d.launches) == (
        before[0] + 1, before[1])
    _check(got, int4_matmul(x, qw, impl="plain", variant="v3"))
    assert torch.equal(got, int4_matmul(x, qw, variant="v3"))


@pytest.mark.parametrize("M,K,N", _TILE_CASES)
def test_int4_glu_cuda(gen, M, K, N):
    qw = _quantize_leaf_int4(_weight(K, N, gen))
    g, u = _randn(M, K, gen=gen), _randn(M, K, gen=gen)
    res = _randn(M, N, gen=gen)
    before = qmm.int4_matmul_2d_glu.launches
    got = qmm.int4_ffn_down(g, u, qw, res)
    assert qmm.int4_matmul_2d_glu.launches == before + 1
    _check(got, qmm.int4_ffn_down(g, u, qw, res, impl="plain"))
    assert torch.equal(got, qmm.int4_ffn_down(g, u, qw, res))


# the row-parallel chunks a rank holds (quantize_params(row_parallel=mp)):
# the 13B's wo and w2 at mp 2 and mp 4 (in 5120, ffn 14336), Falcon-180B's
# wo (in 14848 -> 16384) and dense_4h_to_h (59392) at mp 4; group 32
@pytest.mark.parametrize("M", [4, 33, 300, 1487])
@pytest.mark.parametrize("K,N,chunks", [(5120, 5120, 2), (14336, 5120, 2),
                                        (14336, 5120, 4), (14848, 14848, 4),
                                        (59392, 14848, 4)])
def test_int4_row_parallel_chunk_cuda(gen, M, K, N, chunks):
    """A rank's chunk of a chunk-packed int4 weight (group 32) through the
    kernel: the GEMV at M <= 32 and, since the tiled route takes group 32
    in v1 and glu, the tiled route above; no fallback."""
    qw = _quantize_leaf_int4(_weight(K, N, gen), k_chunks=chunks)
    assert qw.group == 32
    part = qw.chunk(chunks - 1)
    kc = part.in_dim
    x = _randn(M, kc, gen=gen)
    before = (int4_matmul_2d.launches, qmm.fallback_count())
    got = qmm.sharded_matmul(x, part)
    assert (int4_matmul_2d.launches, qmm.fallback_count()) == (
        before[0] + 1, before[1])
    _check(got, int4_matmul(x, part, impl="plain"))
    assert torch.equal(got, qmm.sharded_matmul(x, part))
    if M > 32:
        g, u, res = (_randn(M, kc, gen=gen), _randn(M, kc, gen=gen),
                     _randn(M, N, gen=gen))
        n = qmm.int4_matmul_2d_glu.launches
        got = qmm.int4_ffn_down(g, u, part, res)
        assert qmm.int4_matmul_2d_glu.launches == n + 1
        _check(got, qmm.int4_ffn_down(g, u, part, res, impl="plain"))


def test_int4_chunked_whole_cuda(gen):
    """A whole chunk-packed weight on one card: the kernel a chunk, the
    partials summed in float32, against the plain version of the same."""
    qw = _quantize_leaf_int4(_weight(5120, 1280, gen), k_chunks=2)
    x = _randn(300, 5120, gen=gen)
    before = int4_matmul_2d.launches
    got = int4_matmul(x, qw)
    assert int4_matmul_2d.launches == before + 2
    _check(got, int4_matmul(x, qw, impl="plain"))


def test_tiled_route_refuses_cuda(gen):
    """Shapes the tiled route does not take: the 2-D wrappers raise on the
    card and launch nothing (an int4 weight whose group (16) and K/2 (48)
    are no multiple of a 64-row step, an int8 K that is no multiple of 8,
    an N that is no multiple of 16), and the dispatchers compute them
    through the reference's route (the dense product, the unfused FFN
    tail), one count up in their fallback counters and none in the
    kernels', each output that route's bit for bit (which
    tests/test_torch_quant_domain.py holds against the JAX routes). At M
    <= 32 the GEMVs take the same int4 weight."""
    qw = _quantize_leaf_int4(_weight(96, 64, gen))
    assert (qw.group, qw.q.shape[0]) == (16, 48)
    q8 = _quantize_leaf_int8(_weight(100, 64, gen))
    names = ("int4_matmul_2d", "int4_matmul_2d_v3", "int4_matmul_2d_glu",
             "int8_matmul_2d")
    before = [getattr(qmm, n).launches for n in names]
    x = _randn(64, 96, gen=gen)
    x2, res = _padded(x, qw), _randn(64, 64, gen=gen)
    x8 = _randn(64, 100, gen=gen)
    for call in (lambda: int4_matmul_2d(x2, qw.q, qw.scale, qw.group),
                 lambda: qmm.int4_matmul_2d_v3(x2, qw.q, qw.scale, qw.group),
                 lambda: qmm.int4_matmul_2d_glu(x2, x2, qw.q, qw.scale, res,
                                                qw.group),
                 lambda: qmm.int8_matmul_2d(x8, q8.q, q8.scale)):
        with pytest.raises(ValueError):
            call()
    assert [getattr(qmm, n).launches for n in names] == before

    def counted(mode, call):
        was = (dict(qmm.int4_matmul.fallbacks), qmm.int8_matmul.fallbacks)
        out = call()
        got = (dict(qmm.int4_matmul.fallbacks), qmm.int8_matmul.fallbacks)
        want = (dict(was[0]), was[1] + (mode == "int8"))
        if mode != "int8":
            want[0][mode] += 1
        if mode == "glu":  # its unfused product: the dense route of v1
            want[0]["v1"] += 1
        assert got == want, (got, was)
        return out

    for variant in ("v1", "v3"):
        got = counted(variant, lambda: int4_matmul(x, qw, variant=variant))
        assert torch.equal(got, qmm.int4_matmul_dense(x2, qw.q, qw.scale,
                                                      qw.group))
    g, u = _randn(64, 96, gen=gen), _randn(64, 96, gen=gen)
    got = counted("glu", lambda: qmm.int4_ffn_down(g, u, qw, res))
    assert torch.equal(got, res + int4_matmul(
        torch.nn.functional.silu(g) * u, qw))
    got = counted("int8", lambda: qmm.int8_matmul(x8, q8))
    assert torch.equal(got, qmm.int8_matmul_dense(x8, q8.q, q8.scale))
    # N % 16 != 0: no kernel takes it at any M
    q40 = _quantize_leaf_int4(_weight(1024, 40, gen))
    x40 = _randn(4, 1024, gen=gen)
    got = counted("v1", lambda: int4_matmul(x40, q40))
    assert torch.equal(got, qmm.int4_matmul_dense(x40, q40.q, q40.scale,
                                                  q40.group))
    assert [getattr(qmm, n).launches for n in names] == before
    _check(int4_matmul(x[:32], qw), int4_matmul(x[:32], qw, impl="plain"))
    assert getattr(qmm, names[0]).launches == before[0] + 1


def test_quant_fallback_flags_cuda(gen, monkeypatch):
    """Under the A8 flags a shape their kernel does not take goes to the
    W4A8 or W8A8 prefill math in plain ops, counted apart: M > 32 rows
    with ``W4A8_MAX_M`` raised past the GEMV, and a group of 16 at 300
    rows for the W8A8 tile."""
    qw = _quantize_leaf_int4(_weight(96, 64, gen))
    monkeypatch.setattr(qmm, "W4A8_DECODE", True)
    monkeypatch.setattr(qmm, "W4A8_MAX_M", 64)
    monkeypatch.setattr(qmm, "W8A8_PREFILL", True)
    before = (qmm.int4_matmul_2d_w4a8.launches,
              qmm.int4_matmul_2d_w8a8p.launches,
              dict(qmm.int4_matmul.fallbacks))
    for M, mode, plain in ((40, "w4a8", qmm.int4_matmul_2d_w4a8_plain),
                           (300, "w8a8p", qmm.int4_matmul_2d_w8a8p_plain)):
        x = _randn(M, 96, gen=gen)
        got = int4_matmul(x, qw)
        assert torch.equal(got, plain(_padded(x, qw), qw.q, qw.scale,
                                      qw.group))
    after = dict(qmm.int4_matmul.fallbacks)
    assert after["w4a8"] == before[2]["w4a8"] + 1
    assert after["w8a8p"] == before[2]["w8a8p"] + 1
    assert (qmm.int4_matmul_2d_w4a8.launches,
            qmm.int4_matmul_2d_w8a8p.launches) == before[:2]


def test_tiny_decoder_int4_prefill_cuda(gen):
    """The tiny ens5 config's decoder quantized to int4 (dim 64: K/2 32,
    which the tiled route does not take) prefills on the card:
    its M > 32 linears take the dense route (counted), the head the GEMV,
    and the logits hold to the plain path's within 2e-2 relative (both in
    bf16; the paths differ in summation order and the attention kernel)."""
    from a3vlm_tpu_torch.config import tiny_ens5_config
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import ens5
    from a3vlm_tpu_torch.models.llama import KVCache

    cfg = tiny_ens5_config(128)
    model = MetaModel("llama_ens5", with_visual=True, dtype=torch.bfloat16,
                      vocab_size=128, model_cfg=cfg, seed=0, device="cuda")
    model.quantize(bits=4)
    images = torch.rand(1, cfg.image_size, cfg.image_size, 3, generator=gen,
                        device="cuda").to(torch.bfloat16)
    tokens = torch.randint(3, 128, (1, 40), generator=gen, device="cuda")
    qmm.reset_fallbacks()
    got = {}
    with torch.inference_mode():
        img = model.encode_images(images, impl="plain")
        for impl in ("auto", "plain"):
            cache = KVCache.create(cfg.llama, 1, 40 + img.shape[1],
                                   dtype=torch.bfloat16, device="cuda")
            got[impl] = ens5.prefill(model.params, model.cfg, cache, tokens,
                                     image_tokens=img, impl=impl)[0].float()
    assert qmm.int4_matmul.fallbacks["v1"] > 0
    assert torch.isfinite(got["auto"]).all()
    rel = float((got["auto"] - got["plain"]).norm() / got["plain"].norm())
    assert rel < 2e-2, rel


def test_tiny_decoder_ragged_steps_cuda(gen):
    """A bf16 decoder of head dim 128 (dim 256, 2 layers) on the card: the
    ragged step with every row at one position equals ``decode_step`` bit
    for bit, logits and cache, both through the fused decode kernel once a
    layer; at distinct positions, the ragged step and the verify step hold
    the plain path's logits within 2e-2 relative (bf16 both; summation
    order and the attention kernels differ)."""
    from a3vlm_tpu_torch.config import ModelArgs
    from a3vlm_tpu_torch.models import llama

    args = ModelArgs(dim=256, n_layers=2, n_heads=2, n_kv_heads=2,
                     vocab_size=256, multiple_of=64, max_seq_len=128)
    params = llama.init_llama_params(args, torch.bfloat16, "cuda", gen)
    tokens = torch.randint(3, 256, (4, 20), generator=gen, device="cuda")

    def copy(cache):
        return llama.KVCache([c.clone() for c in cache.k],
                             [c.clone() for c in cache.v])

    with torch.inference_mode():
        cache = llama.KVCache.create(args, 4, 64, dtype=torch.bfloat16,
                                     device="cuda")
        logits, cache, _ = llama.prefill(params, args, cache, tokens)
        nxt = logits.argmax(-1, keepdim=True)
        other = copy(cache)
        before = dec.decode_attention_update.launches
        want, cache = llama.decode_step(params, args, cache, nxt, 20)
        got, other = llama.decode_step_ragged(
            params, args, other, nxt,
            torch.full((4,), 20, dtype=torch.int32, device="cuda"))
        assert dec.decode_attention_update.launches == before + 4
        assert torch.equal(got, want)
        for a, b in zip((*cache.k, *cache.v), (*other.k, *other.v)):
            assert torch.equal(a, b)

        pos = torch.tensor([3, 20, 9, 0], dtype=torch.int32, device="cuda")
        window = torch.randint(3, 256, (4, 5), generator=gen, device="cuda")
        for step, toks in ((llama.decode_step_ragged, window[:, :1]),
                           (llama.decode_step_ragged_multi, window)):
            out = {impl: step(params, args, copy(cache), toks, pos,
                              impl)[0].float()
                   for impl in ("auto", "plain")}
            assert torch.isfinite(out["auto"]).all()
            rel = float((out["auto"] - out["plain"]).norm()
                        / out["plain"].norm())
            assert rel < 2e-2, rel


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


@pytest.mark.parametrize("M,K,N", [
    (M, K, N) for M in (33, 255, 256, 257, 1487) for K, N in _EDGE_KN
] + [(M, K, N) for M in (1487, 4 * 1487)
     for K, N in ((5120, 5120), (13824, 5120))])
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


def test_int4_w8a8p_refuses_cuda(gen):
    """The W8A8 prefill tile takes K/2 and group in multiples of 64, as
    the tiled route does; anything else raises and launches nothing."""
    qw = _quantize_leaf_int4(_weight(96, 64, gen))
    x = _padded(_randn(300, 96, gen=gen), qw)
    before = qmm.int4_matmul_2d_w8a8p.launches
    with pytest.raises(ValueError):
        qmm.int4_matmul_2d_w8a8p(x, qw.q, qw.scale, qw.group)
    assert qmm.int4_matmul_2d_w8a8p.launches == before


# The GEMV (M <= 32) in its modes: the int4 modes, W4A8 and int8 at every
# decode batch and verify span up to 32, on both sides of its 8-row
# fragments, over the decoder linears, the edge shapes, the smallest weight
# the quantizer makes (group 16, K/2 48) and one whose K/2 is no multiple
# of 8 (group 2: x goes in as a padded copy); hand-made groups below
# (test_int4_gemv_groups_cuda).
_GEMV_MS = [1, 2, 3, 4, 5, 8, 9, 16, 31, 32]
_A8_MS = [1, 4, 8, 9, 32]
_GEMV_KN = ([(5120, 5120), (5120, 13824), (13824, 5120), (5120, 32000)]
            + _EDGE_KN + [(96, 64), (100, 48)])
_GEMV_WEIGHTS: dict = {}
_GEMV_WRAPPERS = {"v1": "int4_matmul_2d", "v3": "int4_matmul_2d_v3",
                  "glu": "int4_matmul_2d_glu", "w4a8": "int4_matmul_2d_w4a8",
                  "int8": "int8_matmul_2d"}


def _gemv_weight(K, N, gen, bits=4):
    if (K, N, bits) not in _GEMV_WEIGHTS:
        quantize = _quantize_leaf_int8 if bits == 8 else _quantize_leaf_int4
        _GEMV_WEIGHTS[(K, N, bits)] = quantize(_weight(K, N, gen))
    return _GEMV_WEIGHTS[(K, N, bits)]


def _gemv_case(mode, qw, M, gen):
    """(call, direct): ``call(impl)`` through the dispatcher of ``mode``
    (W4A8: with its flag set), ``direct()`` the 2-D wrapper on the padded
    operands."""
    K = qw.in_dim if mode != "int8" else qw.q.shape[0]
    if mode == "glu":
        g, u = _randn(M, K, gen=gen), _randn(M, K, gen=gen)
        res = _randn(M, qw.q.shape[1], gen=gen)
        g2, u2 = _padded(g, qw), _padded(u, qw)
        return (lambda impl: qmm.int4_ffn_down(g, u, qw, res, impl),
                lambda: qmm.int4_matmul_2d_glu(g2, u2, qw.q, qw.scale, res,
                                               qw.group))
    x = _randn(M, K, gen=gen)
    if mode == "int8":
        return (lambda impl: qmm.int8_matmul(x, qw, impl),
                lambda: qmm.int8_matmul_2d(x, qw.q, qw.scale))
    x2 = _padded(x, qw)
    wrapper = getattr(qmm, _GEMV_WRAPPERS[mode])
    return (lambda impl: int4_matmul(x, qw, impl,
                                     variant="v1" if mode == "w4a8" else mode),
            lambda: wrapper(x2, qw.q, qw.scale, qw.group))


def _kernel_names(fn, calls: int) -> tuple:
    """(names, outputs) of ``calls`` calls of ``fn``: the device kernels
    they launch, one entry a launch (``torch.profiler``, which now and then
    drops a kernel event: a name may be missing, none is invented), and
    what each call returned."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        outs = [fn() for _ in range(calls)]
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages() for _ in range(e.count)
            if str(e.device_type).endswith("CUDA")
            and not e.key.startswith("Mem")], outs


def _hold_gemv(mode, qw, M, gen, monkeypatch=None):
    if mode == "w4a8":
        monkeypatch.setattr(qmm, "W4A8_DECODE", True)
    call, direct = _gemv_case(mode, qw, M, gen)
    wrapper = getattr(qmm, _GEMV_WRAPPERS[mode])
    before = (wrapper.launches, qmm.fallback_count())
    got = call("auto")
    assert (wrapper.launches, qmm.fallback_count()) == (before[0] + 1,
                                                        before[1])
    _check(got, call("plain"))
    assert torch.equal(got, call("auto"))  # a relaunch, the same bits
    # one launch a call: over 10 calls the GEMV is the only kernel (no
    # second pass; W4A8's quantizer comes before it, and where a row is no
    # multiple of 16 bytes the inputs come as padded copies, whose kernels
    # come besides), exactly once a call in at least one of five profiled
    # runs (the profiler may drop an event, or now and then a whole run's,
    # never add one), and every profiled call gives the same bits
    rows = qw.q.shape[0]
    padded = rows % (16 if mode == "w4a8" else 8) != 0
    for _ in range(5):
        names, outs = _kernel_names(direct, 10)
        assert all(torch.equal(out, got) for out in outs)
        gemv = [n for n in names if "gemv_cluster_kernel" in n]
        quant = [n for n in names if "quantize_act_kernel" in n]
        others = [n for n in names if n not in gemv + quant]
        assert len(gemv) <= 10 and len(quant) <= 10, names
        assert not any("splitk" in n for n in names), set(names)
        assert not quant or mode == "w4a8", set(names)
        assert not others or padded, set(names)
        if len(gemv) == 10:
            break
    assert len(gemv) == 10, names


@pytest.mark.parametrize("mode", ["v1", "v3", "glu"])
@pytest.mark.parametrize("M", _GEMV_MS)
@pytest.mark.parametrize("K,N", _GEMV_KN)
def test_int4_gemv_cuda(gen, mode, M, K, N):
    _hold_gemv(mode, _gemv_weight(K, N, gen), M, gen)


@pytest.mark.parametrize("M", _A8_MS)
@pytest.mark.parametrize("K,N", _GEMV_KN)
def test_int4_w4a8_gemv_cuda(gen, monkeypatch, M, K, N):
    """K7: the quantizer and one GEMV launch a call, within the plain
    bound of its twin (the same int8 activations and exact integer group
    sums; the f32 sum of the groups in another order)."""
    _hold_gemv("w4a8", _gemv_weight(K, N, gen), M, gen, monkeypatch)


@pytest.mark.parametrize("M", _A8_MS)
@pytest.mark.parametrize("K,N", _GEMV_KN[:-2] + [(1000, 1200), (100, 48),
                                                 (97, 64)])
def test_int8_gemv_cuda(gen, M, K, N):
    """K6's GEMV, K unpadded: 13824, 1000 (no multiple of a 64-row stage),
    100 and 97 (no multiple of 8: x goes in as a padded copy)."""
    _hold_gemv("int8", _gemv_weight(K, N, gen, bits=8), M, gen)


# Groups no quantizer here makes but the wrapper takes (any divisor of
# K/2): 48 (its run is 3 stages, and a stage meets two groups) and 24 (a
# 16-row step meets two groups: v3 takes one masked product a group; so
# does a 32-row step of W4A8).
@pytest.mark.parametrize("mode", ["v1", "v3", "glu", "w4a8"])
@pytest.mark.parametrize("M", [1, 9, 32])
@pytest.mark.parametrize("half,N,group", [
    (96, 64, 48), (96, 64, 24), (1920, 1200, 48), (1920, 1200, 24)])
def test_int4_gemv_groups_cuda(gen, monkeypatch, mode, M, half, N, group):
    q = torch.randint(-128, 128, (half, N), generator=gen, device="cuda",
                      dtype=torch.int32).to(torch.int8)
    scale = ((torch.rand(2 * half // group, N, generator=gen, device="cuda")
              + 0.5) / (2 * half) ** 0.5).contiguous()
    _hold_gemv(mode, QuantizedWeight(q, scale, bits=4, group=group,
                                     in_dim=2 * half), M, gen, monkeypatch)


# The row quantizer against its twin bit for bit: decode rows and the
# prefill's, K a multiple of 8 and not (the one-element loads), rows of
# zeros (the 1e-8 floor), a single huge value among small ones, values at
# half steps of the quantization grid, and float32 input.
@pytest.mark.parametrize("M,K", [(1, 5120), (4, 14336), (9, 5120),
                                 (32, 13824), (32, 1001), (7, 97),
                                 (1487, 5120), (3, 8)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_quantize_act_int8_cuda(gen, M, K, dtype):
    x = torch.randn(M, K, generator=gen, device="cuda").to(dtype)
    if M > 1:  # one huge value among tiny ones
        x[1, :K // 2] *= 1e-30
        x[1, K // 2] = 3.0e38
    if M > 2:  # absmax 127, so s = 1 and x / s lands on halves
        x[2] = torch.arange(K, device="cuda").remainder(128) - 63.5
        x[2, 0] = 127.0
    if M > 3:
        x[3] = 0.0
    before = qmm.quantize_act_int8.launches
    q, s = qmm.quantize_act_int8(x)
    assert qmm.quantize_act_int8.launches == before + 1
    wq, ws = qmm.quantize_act_int8_plain(x)
    assert q.dtype == torch.int8 and s.shape == (M, 1)
    assert torch.equal(q, wq), int((q != wq).sum())
    assert torch.equal(s, ws)
    names, _ = _kernel_names(lambda: qmm.quantize_act_int8(x), 5)
    assert names and all("quantize_act_kernel" in n for n in names), names


# -- the fine-tuning loop on the card: checkpoints of card tensors --------

def _card_tree(gen, layers=3, d=256):
    """A port tree on the card: a per-layer decoder with a bf16 leaf and a
    frozen base, adapters, a float32 tag."""
    return {
        "llama": {"layers": [
            {"attention_norm": {"weight": _randn(d, gen=gen)},
             "attention": {"wq": {"weight": _randn(d, d, gen=gen).float()}}}
            for _ in range(layers)],
            "norm": {"weight": _randn(d, gen=gen).float()}},
        "start_img": _randn(1, 1, d, gen=gen).float(),
        "lora": {"layers": [{"attention": {"wq": {
            "a": _randn(d, 16, gen=gen).float(),
            "b": _randn(16, d, gen=gen).float()}}} for _ in range(layers)]},
    }


def _card_mask(tree):
    from a3vlm_tpu_torch.quant import tree_map

    mask = tree_map(lambda _: True, tree)
    for lp in mask["llama"]["layers"]:
        lp["attention"]["wq"]["weight"] = False
    return mask


def _card_loss(params, batch):
    x = batch["x"]
    for lp, ab in zip(params["llama"]["layers"], params["lora"]["layers"]):
        a, b = ab["attention"]["wq"]["a"], ab["attention"]["wq"]["b"]
        x = torch.tanh(x @ lp["attention"]["wq"]["weight"] + (x @ a) @ b) \
            * lp["attention_norm"]["weight"].float()
    return ((x * params["llama"]["norm"]["weight"]).sum()
            + params["start_img"].sum()) ** 2 / x.numel()


def _card_state(gen):
    from a3vlm_tpu_torch.train.step import AdamW, TrainState, make_train_step

    tree = _card_tree(gen)
    mask = _card_mask(tree)
    opt = AdamW(1e-2)
    return (TrainState.create(tree, opt, mask),
            make_train_step(_card_loss, opt, trainable_mask=mask), mask)


def _card_leaves(state, mask):
    from a3vlm_tpu_torch.train.step import partition_params, tree_leaves

    return (tree_leaves(partition_params(state.params, mask)[0])
            + tree_leaves(state.opt_state.mu) + tree_leaves(state.opt_state.nu))


def test_checkpoint_round_trip_cuda(gen, tmp_path):
    """Saved from the card and restored onto it: every leaf on the card,
    in its dtype (bf16 kept), bit for bit; the frozen leaves are the live
    ones; the count and step come back."""
    from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager
    from a3vlm_tpu_torch.train.step import TrainState

    state, step, mask = _card_state(gen)
    x = _randn(8, 256, gen=gen).float()
    state, _ = step(state, {"x": x})
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(0, 1, params=state.params, opt_state=state.opt_state,
                    step=state.step, trainable_mask=mask, wait=False)
    mgr.wait_until_finished()
    params = mgr.restore_params(path, state.params)
    extra = mgr.restore_train_state(path, state.opt_state)
    restored = TrainState(params, extra["opt_state"], extra["step"])
    got, want = _card_leaves(restored, mask), _card_leaves(state, mask)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.is_cuda and a.dtype == b.dtype and torch.equal(a, b)
    assert params["llama"]["layers"][0]["attention"]["wq"]["weight"] is \
        state.params["llama"]["layers"][0]["attention"]["wq"]["weight"]
    assert (restored.step, restored.opt_state.count) == (1, 1)


def test_params_to_host_stacks_in_chunks_cuda(gen, monkeypatch):
    """``params_to_host`` and ``params_to_numpy`` stack a card tree's layer
    lists leaf by leaf, ``STACK_CHUNK_BYTES`` of one leaf's layers at a
    time on the card: the card holds at most about a chunk more, not a
    stacked copy of the layers, and the stacked leaves equal the
    layers'."""
    from a3vlm_tpu_torch.checkpoint import bridge
    from a3vlm_tpu_torch.checkpoint.bridge import (
        params_to_host,
        params_to_numpy,
    )

    L, D = 8, 512
    monkeypatch.setattr(bridge, "STACK_CHUNK_BYTES", 2 * D * D * 4)
    layers = [{"attention": {"wq": {"weight": _randn(D, D, gen=gen).float()}},
               "attention_norm": {"weight": _randn(D, gen=gen)}}
              for _ in range(L)]
    tree = {"llama": {"layers": layers, "norm": {"weight": _randn(D, gen=gen)}}}
    one_leaf = D * D * 4
    for fn in (params_to_host, params_to_numpy):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        out = fn(tree)
        extra = torch.cuda.max_memory_allocated() - base
        assert extra <= 2 * bridge.STACK_CHUNK_BYTES < L * one_leaf, (
            fn.__name__, extra)
        wq = out["llama"]["layers"]["attention"]["wq"]["weight"]
        norm = out["llama"]["layers"]["attention_norm"]["weight"]
        assert tuple(wq.shape) == (L, D, D) and tuple(norm.shape) == (L, D)
        for i, lp in enumerate(layers):
            want = lp["attention"]["wq"]["weight"].cpu()
            assert torch.equal(torch.as_tensor(wq[i]), want)
            want = lp["attention_norm"]["weight"].cpu()
            if fn is params_to_numpy:
                want = want.float()
            assert torch.equal(torch.as_tensor(norm[i]), want)
    assert params_to_host(tree)["llama"]["norm"]["weight"].dtype == \
        torch.bfloat16


def test_async_save_racing_a_step_cuda(gen, tmp_path):
    """A step launched at once after an asynchronous save (the optimizer
    updates parameters and moments in place on the card) does not reach
    the written files: they hold the values of before the step."""
    from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager
    from a3vlm_tpu_torch.train.step import TrainState

    state, step, mask = _card_state(gen)
    x = _randn(64, 256, gen=gen).float()
    mgr = CheckpointManager(str(tmp_path))
    for i in range(3):
        before = [t.clone() for t in _card_leaves(state, mask)]
        path = mgr.save(0, i + 1, params=state.params,
                        opt_state=state.opt_state, step=state.step,
                        trainable_mask=mask, wait=False)
        for _ in range(4):
            state, _ = step(state, {"x": x})
        mgr.wait_until_finished()
        restored = TrainState(
            mgr.restore_params(path, state.params),
            mgr.restore_train_state(path, state.opt_state)["opt_state"], 0)
        for a, b in zip(_card_leaves(restored, mask), before):
            assert torch.equal(a, b)
        assert not torch.equal(_card_leaves(state, mask)[0], before[0])


def test_load_adapter_checkpoint_cuda(gen, tmp_path):
    """An int4 llama_ens5 on the card (tiny towers, a decoder of head dim
    128 as the decode kernel takes) serves adapters from a checkpoint of
    the port: the greedy ids of ``load_lora`` with the same adapters and
    dense trainables."""
    import dataclasses

    from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager
    from a3vlm_tpu_torch.config import ModelArgs, tiny_ens5_config
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.quant import tree_map
    from a3vlm_tpu_torch.train.lora import init_lora_params

    cfg = dataclasses.replace(tiny_ens5_config(), llama=ModelArgs(
        dim=256, n_layers=2, n_heads=2, n_kv_heads=2, vocab_size=128,
        multiple_of=64, max_seq_len=256))

    def build():
        m = MetaModel("llama_ens5", with_visual=True, max_seq_len=256,
                      dtype=torch.bfloat16, vocab_size=100, model_cfg=cfg,
                      device="cuda", seed=0)
        m.quantize(bits=4)
        return m

    model = build()
    lora = init_lora_params(torch.Generator(device="cuda").manual_seed(3),
                            model.params["llama"], rank=4)
    lora = tree_map(lambda t: t + 0.05 * torch.randn(
        t.shape, generator=gen, device="cuda"), lora)
    norm = model.params["llama"]["norm"]["weight"]
    norm = norm + (0.05 * torch.randn(norm.shape, generator=gen,
                                      device="cuda")).to(norm.dtype)
    path = CheckpointManager(str(tmp_path)).save(
        0, params={"llama": {"norm": {"weight": norm}}, "lora": lora})
    prompts = [[1, 5, 9, 14, 20], [1, 7, 7, 30]]
    model.params["llama"]["norm"]["weight"] = norm
    model.load_lora(lora)
    want = model.generate_tokens(prompts, max_gen_len=8, stop_tokens=())
    served = build()
    served.load_adapter_checkpoint(path)
    got = served.params["llama"]["norm"]["weight"]
    assert got.is_cuda and torch.equal(got, norm)
    assert served.generate_tokens(prompts, max_gen_len=8,
                                  stop_tokens=()) == want


# The other families' shapes (InternLM2-7B's grouped-query attention, 32
# query heads over 8 kv heads with D 128, its prefill of [BOS | 1295 image
# words | 45 ids] and its decoder linears; the 2-image model's prefill of
# [BOS | 2910 image words | 45 ids]).
@pytest.mark.parametrize("B,hq,hkv,S", [(1, 32, 8, 1341), (4, 32, 8, 1341),
                                        (1, 40, 40, 2956)])
def test_flash_attention_families_cuda(gen, B, hq, hkv, S):
    q = _randn(B, hq, S, 128, gen=gen)
    k, v = _randn(B, hkv, S, 128, gen=gen), _randn(B, hkv, S, 128, gen=gen)
    _check(flash_attention_bhsd(q, k, v, causal=True),
           flash_attention_bhsd_plain(q, k, v, causal=True))


@pytest.mark.parametrize("B", [1, 4])
def test_decode_attention_gqa4_cuda(gen, B):
    """K3 (fused write), K3u and K4 fused at G 4 over a cache past the
    InternLM2 prefill: each against its plain version, the caches bit for
    bit."""
    Hkv, G, S, D = 8, 4, 1384, 128
    q, ck, cv, xk, xv, pos = _cache_case(gen, B, Hkv, G, S)
    k1, v1, k2, v2 = ck.clone(), cv.clone(), ck.clone(), cv.clone()
    args = (xk.reshape(B, Hkv, D), xv.reshape(B, Hkv, D), pos, pos + 1)
    _check(decode_attention_update(q.reshape(B, Hkv, G, D), k1, v1, *args),
           decode_attention_update_plain(q.reshape(B, Hkv, G, D), k2, v2,
                                         *args))
    assert torch.equal(k1, k2) and torch.equal(v1, v2)
    _check(dec.decode_attention(q, k1, v1, pos + 1),
           dec.decode_attention_plain(q, k1, v1, pos + 1))
    kq, vq = _quantized(ck, cv)
    q1, w1, q2, w2 = (QuantizedKV(c.qv.clone(), c.scale.clone())
                      for c in (kq, vq, kq, vq))
    _check(dec.decode_attention_update_quant(q, q1, w1, xk, xv, pos, pos + 1),
           dec.decode_attention_update_quant_plain(q, q2, w2, xk, xv, pos,
                                                   pos + 1))
    for a, b in zip((*q1, *w1), (*q2, *w2)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("B", [1, 4])
def test_verify_attention_gqa4_cuda(gen, B):
    """K5 and K5q at G 4 with a draft_k=8 window (span 9: 36 query rows a
    kv head)."""
    q, ck, cv, _, _, pos = _cache_case(gen, B, 8, 4, 1384, span=9)
    _verify_both(q, ck, cv, pos + 1)


@pytest.mark.parametrize("M", [1, 4])
@pytest.mark.parametrize("K,N", [(4096, 1024), (4096, 92544)])
def test_int4_gemv_families_cuda(gen, M, K, N):
    """K1's GEMV on InternLM2's wk/wv and its 92544-wide head."""
    _hold_gemv("v1", _gemv_weight(K, N, gen), M, gen)


def _family_kernels_vs_plain(model, tokens, image_kw):
    """Image tokens and prefill logits of a model on the card through the
    kernel path and the plain path: (rel err of the tokens, of the
    logits)."""
    from a3vlm_tpu_torch.models.llama import KVCache, prefill

    out = {}
    with torch.inference_mode():
        for impl in ("auto", "plain"):
            img = model.encode_images(**image_kw, impl=impl)
            cache = KVCache.create(model.args, tokens.shape[0],
                                   tokens.shape[1] + img.shape[1],
                                   dtype=torch.bfloat16, device="cuda")
            out[impl] = (img.float(), prefill(model.decoder, model.args,
                                              cache, tokens, img,
                                              impl)[0].float())
    return tuple(float((a - b).norm() / b.norm())
                 for a, b in zip(out["auto"], out["plain"]))


def test_tiny_internlm_on_the_card_cuda(gen):
    """A tiny ``internlm_ems5_light`` (its towers at 20 crops, a decoder of
    head dim 128 with 2 query heads a kv head, int4) on the card: image
    tokens and prefill logits of the kernel path within 2e-2 relative of
    the plain path's, and a greedy request through ``generate_tokens``."""
    import dataclasses

    from a3vlm_tpu_torch.config import ModelArgs
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import internlm_ems5_light as il

    cfg = dataclasses.replace(il.tiny_config(256), llama=ModelArgs(
        dim=512, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=256,
        multiple_of=64, rope_theta=1e6, max_seq_len=512))
    model = MetaModel("internlm_ems5_light", with_visual=True,
                      dtype=torch.bfloat16, vocab_size=256, model_cfg=cfg,
                      seed=0, device="cuda")
    model.quantize(bits=4)
    images = torch.randn(4, 128, 128, 3, generator=gen,
                         device="cuda").to(torch.bfloat16)
    tokens = torch.randint(3, 256, (4, 40), generator=gen, device="cuda")
    img_rel, rel = _family_kernels_vs_plain(model, tokens,
                                            {"images": images})
    assert img_rel < 2e-2 and rel < 2e-2, (img_rel, rel)
    out = model.generate_tokens(tokens[:1].tolist(), images=images[:1],
                                max_gen_len=8)
    assert len(out) == 1 and all(0 <= t < 256 for t in out[0])


def test_tiny_2images_on_the_card_cuda(gen):
    """A tiny ``llama_ens5_2images`` on the card: both streams through the
    towers, image tokens and prefill logits within 2e-2 relative of the
    plain path's; without depth images it refuses."""
    import dataclasses

    from a3vlm_tpu_torch.config import ModelArgs, tiny_ens5_config
    from a3vlm_tpu_torch.meta import MetaModel

    cfg = dataclasses.replace(tiny_ens5_config(256), llama=ModelArgs(
        dim=256, n_layers=2, n_heads=2, vocab_size=256, multiple_of=64,
        max_seq_len=512))
    model = MetaModel("llama_ens5_2images", with_visual=True,
                      dtype=torch.bfloat16, vocab_size=256, model_cfg=cfg,
                      seed=0, device="cuda")
    assert model.image_words == 2 * cfg.image_words
    images, depth = (torch.randn(2, 56, 56, 3, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(2))
    tokens = torch.randint(3, 256, (2, 40), generator=gen, device="cuda")
    img_rel, rel = _family_kernels_vs_plain(
        model, tokens, {"images": images, "depth_images": depth})
    assert img_rel < 2e-2 and rel < 2e-2, (img_rel, rel)
    with pytest.raises(ValueError, match="depth"):
        model.generate_tokens(tokens.tolist(), images=images, max_gen_len=2)


@pytest.mark.parametrize("kv_heads,multi_query", [(2, False), (1, True)])
def test_tiny_falcon_on_the_card_cuda(gen, kv_heads, multi_query):
    """A tiny ``falcon`` (head dim 64, grouped-query or multi-query, int4)
    on the card: prefill and decode logits of the kernel path within 2e-2
    relative of the plain path's over the bf16 and the int8 cache (the
    decode kernel's head-dim-64 instance launched each step), and a greedy
    request through ``generate_tokens``."""
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models import falcon

    args = falcon.FalconArgs(num_layers=2, hidden_size=256,
                             num_attention_heads=4, num_kv_heads=kv_heads,
                             multi_query=multi_query)
    model = MetaModel("falcon", dtype=torch.bfloat16, vocab_size=256,
                      model_cfg=args, max_seq_len=512, seed=0,
                      device="cuda")
    model.quantize(bits=4)
    tokens = torch.randint(3, 256, (4, 40), generator=gen, device="cuda")
    for dtype, wrapper in ((torch.bfloat16, dec.decode_attention_update),
                           (torch.int8, dec.decode_attention_update_quant)):
        out = {}
        with torch.inference_mode():
            for impl in ("auto", "plain"):
                cache = falcon.FalconKVCache.create(
                    model.args, 4, 44, dtype=dtype, device="cuda")
                logits, cache, S = falcon.prefill(
                    model.decoder, model.args, cache, tokens[:, :36], impl)
                before = wrapper.launches
                steps = [logits]
                for i in range(4):
                    steps.append(falcon.decode_step(
                        model.decoder, model.args, cache,
                        tokens[:, 36 + i:37 + i], S + i, impl)[0])
                if impl == "auto":
                    assert wrapper.launches == before + 4 * args.num_layers
                out[impl] = torch.stack(steps)
        rel = float((out["auto"] - out["plain"]).norm()
                    / out["plain"].norm())
        assert rel < 2e-2, (dtype, rel)
    ids = model.generate_tokens(tokens[:2].tolist(), max_gen_len=8)
    assert len(ids) == 2 and all(0 <= t < 256 for o in ids for t in o)
