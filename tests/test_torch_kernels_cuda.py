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

from a3vlm_tpu_torch.ops.decode_attention import (
    decode_attention_update,
    decode_attention_update_plain,
)
from a3vlm_tpu_torch.ops.flash_attention import (
    flash_attention,
    flash_attention_bhsd,
    flash_attention_bhsd_plain,
    flash_attention_bwd,
    flash_attention_bwd_dkv,
    flash_attention_bwd_dq,
    flash_attention_bwd_plain,
)
from a3vlm_tpu_torch.ops.quant_matmul import int4_matmul, int4_matmul_2d
from a3vlm_tpu_torch.ops.vit_attention import (
    vit_attention,
    vit_attention_plain,
)
from a3vlm_tpu_torch.quant import _quantize_leaf_int4

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


@pytest.mark.parametrize("hq,hkv,sq,skv", [(40, 40, 1487, 1487),
                                           (40, 8, 1487, 1487),
                                           (40, 40, 512, 1487)])
def test_flash_attention_cuda(gen, hq, hkv, sq, skv):
    q = _randn(4, hq, sq, 128, gen=gen)
    k = _randn(4, hkv, skv, 128, gen=gen)
    v = _randn(4, hkv, skv, 128, gen=gen)
    _check(flash_attention_bhsd(q, k, v, causal=True),
           flash_attention_bhsd_plain(q, k, v, causal=True))


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


@pytest.mark.parametrize("H,D", [(16, 64), (16, 88), (24, 64)])
def test_vit_attention_cuda(gen, H, D):
    q, k, v = (_randn(20, 257, H, D, gen=gen) for _ in range(3))
    _check(vit_attention(q, k, v), vit_attention_plain(q, k, v))


# hq, hkv, sq, skv, D: equal, GQA, right-aligned unequal, more rows than
# keys (rows with no visible key), ragged lengths, head dims 64 and 88
_BWD_CASES = [(4, 4, 256, 256, 128), (8, 2, 300, 300, 128),
              (4, 4, 100, 333, 64), (4, 2, 200, 77, 88), (2, 1, 45, 45, 128)]


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
