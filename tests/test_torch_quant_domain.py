"""The shape domain of the port's quantized-matmul kernels and the routes
its dispatchers take outside it, against the JAX dispatcher on the CPU.

On the card ``int4_matmul``, ``int4_ffn_down`` and ``int8_matmul`` check
from the shapes alone whether the mode's kernel takes a call, as the JAX
dispatcher checks ``_kernel_eligible`` and ``_int8_kernel_eligible``, and
send the rest to the reference's route for that mode: the dense two
products of ``_int4_matmul_xla`` (v1, v3), the W4A8 and W8A8 prefill math
of ``_int4_w4a8_xla`` and ``_int4_w8a8p_xla``, the unfused FFN tail, and
``x @ (q * scale)`` for int8. Off the TPU the JAX dispatcher takes those
same routes for every shape, so each fallback is held here against it.

Tolerances: the dense routes 1e-5 in float32 (the same products, summed in
another order) and 2^-6 in bf16 (each side rounds the dequantized weight
and the products to bf16); W4A8 1e-5 (exact integer group sums, float32
sums of the groups in another order); W8A8 prefill bit-identical (exact
integer sums, one epilogue order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.ops import quant_matmul as jqm
from a3vlm_tpu_torch import quant as tquant
from a3vlm_tpu_torch.ops import quant_matmul as tqm

torch.set_num_threads(1)
BF16_RTOL = 2.0 ** -6


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(dtype)


def _np(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


def _check(got, want, bf16):
    got, want = _np(got), _np(want)
    if bf16:
        bound = BF16_RTOL * np.abs(want) + 1e-3 * np.abs(want).max()
        assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _pair(K, N, seed, bits=4):
    w = _rand((K, N), seed, 0.05)
    if bits == 8:
        return jquant._quantize_leaf_int8(w), tquant._quantize_leaf_int8(_t(w))
    return jquant._quantize_leaf_int4(w), tquant._quantize_leaf_int4(_t(w))


@pytest.fixture
def one_device(monkeypatch):
    """The JAX dispatchers take their single-device routes (and read their
    mode flags) only when ``jax.devices()`` has one entry; the tests run on
    a forced 8-device CPU mesh, so pin the count, as the JAX package's own
    tests do."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])
    jax.clear_caches()
    yield
    jax.clear_caches()


# ------------------------------------------------------ the pure domain
# (mode, M, half, N, group, taken): the GEMV takes any group that divides
# K/2; the tiled routes and K8 half and group in multiples of 64; N % 16
# for all; W4A8 no more than 32 rows (its GEMV).
_INT4_DOMAIN = [
    ("v1", 1, 2560, 5120, 64, True), ("v1", 1487, 2560, 5120, 64, True),
    ("v1", 32, 32, 128, 32, True), ("v1", 33, 32, 128, 32, False),
    ("v1", 4, 48, 64, 16, True), ("v1", 64, 48, 64, 16, False),
    ("v1", 4, 512, 40, 64, False), ("v1", 300, 512, 40, 64, False),
    ("v1", 300, 96, 64, 48, False), ("v1", 8, 96, 64, 48, True),
    ("v3", 33, 32, 128, 32, False), ("v3", 1, 50, 48, 2, True),
    ("glu", 32, 88, 64, 8, True), ("glu", 40, 88, 64, 8, False),
    ("glu", 40, 7168, 5120, 64, True), ("glu", 1, 512, 40, 64, False),
    ("w4a8", 1, 2560, 5120, 64, True), ("w4a8", 32, 48, 64, 24, True),
    ("w4a8", 33, 2560, 5120, 64, False), ("w4a8", 4, 512, 40, 64, False),
    ("w8a8p", 1487, 2560, 5120, 64, True), ("w8a8p", 1, 2560, 5120, 64, True),
    ("w8a8p", 300, 48, 64, 16, False), ("w8a8p", 300, 512, 40, 64, False),
    ("v1", 1, 48, 64, 32, False),  # a group that does not divide K/2
]


@pytest.mark.parametrize("mode,M,half,N,group,taken", _INT4_DOMAIN)
def test_int4_kernel_domain(mode, M, half, N, group, taken):
    assert tqm.int4_kernel_takes(mode, M, half, N, group) is taken


@pytest.mark.parametrize("M,K,N,taken", [
    (1, 5120, 5120, True), (32, 97, 64, True), (33, 97, 64, False),
    (1487, 13824, 5120, True), (4, 1024, 40, False), (300, 100, 48, False),
])
def test_int8_kernel_domain(M, K, N, taken):
    assert tqm.int8_kernel_takes(M, K, N) is taken
    fn, fallback = tqm.int8_route(M, K, N)
    assert fallback is (not taken)
    assert fn is (tqm.int8_matmul_2d if taken else tqm.int8_matmul_dense)
    assert tqm.int8_route(M, K, N, impl="plain")[0] is (
        tqm.int8_matmul_2d_plain if taken else tqm.int8_matmul_dense)
    # off the card the wrapper (which takes its plain version there)
    assert tqm.int8_route(M, K, N, card=False) == (tqm.int8_matmul_2d, False)


@pytest.mark.parametrize("flags,M,half,N,group,want", [
    ({}, 40, 32, 128, 32, "v1"),
    ({"_AUTO_VARIANT": "v3"}, 40, 32, 128, 32, "v3"),
    ({"W4A8_DECODE": True}, 4, 512, 40, 64, "w4a8"),
    ({"W4A8_DECODE": True, "W4A8_MAX_M": 64}, 40, 2560, 5120, 64, "w4a8"),
    ({"W8A8_PREFILL": True}, 300, 48, 64, 16, "w8a8p"),
])
def test_int4_route_refused(monkeypatch, flags, M, half, N, group, want):
    """A shape the mode's kernel refuses takes the reference's route for
    that mode on the card, whatever ``impl``; off the card the wrapper."""
    for name, value in flags.items():
        monkeypatch.setattr(tqm, name, value)
    assert tqm.int4_mode(M) == want
    for impl in ("auto", "plain"):
        fn, fallback = tqm.int4_route(M, half, N, group, impl=impl)
        assert (fn, fallback) == (tqm.INT4_FALLBACK[want], want)
    fn, fallback = tqm.int4_route(M, half, N, group, card=False)
    assert fallback is None and fn is not tqm.INT4_FALLBACK[want]


@pytest.mark.parametrize("flags,M,want,plain", [
    ({}, 4, "v1", "int4_matmul_2d_plain"),
    ({}, 1487, "v1", "int4_matmul_2d_plain"),
    ({"_AUTO_VARIANT": "v3"}, 4, "v3", "int4_matmul_2d_v3_plain"),
    ({"W4A8_DECODE": True}, 4, "w4a8", "int4_matmul_2d_w4a8_plain"),
    ({"W8A8_PREFILL": True}, 1487, "w8a8p", "int4_matmul_2d_w8a8p_plain"),
    ({"PREFILL_DENSE_MIN_M": 256}, 1487, "dense", "int4_matmul_dense"),
])
def test_int4_route_taken(monkeypatch, flags, M, want, plain):
    """Every 13B shape lies in the kernels' domain: the mode's wrapper (or
    its plain version), no fallback."""
    for name, value in flags.items():
        monkeypatch.setattr(tqm, name, value)
    for half, N in ((2560, 5120), (2560, 13824), (7168, 5120),
                    (2560, 32000)):
        fn, fallback = tqm.int4_route(M, half, N, 64)
        assert fallback is None and tqm.int4_mode(M) == want
        assert tqm.int4_route(M, half, N, 64, impl="plain")[0] is getattr(
            tqm, plain)
        if want == "dense":
            assert fn is tqm.int4_matmul_dense
        else:
            assert fn is not getattr(tqm, plain)


# ----------------------------------- each fallback against the JAX route
@pytest.mark.parametrize("M,K,N", [(40, 64, 128), (40, 176, 64), (4, 1024, 40),
                                   (300, 96, 64)])
@pytest.mark.parametrize("bf16", [False, True])
def test_int4_dense_fallback_matches_jax(one_device, M, K, N, bf16):
    """v1 and v3 outside the domain (the tiny decoder's K 64 and 176, group
    32 and 8, at prefill; N % 16 != 0; group 16 at 300 rows) against the
    JAX dispatcher, which takes ``_int4_matmul_xla`` there."""
    j4, t4 = _pair(K, N, 90 + K)
    half = t4.q.shape[0]
    assert not tqm.int4_kernel_takes("v1", M, half, N, t4.group)
    assert not tqm.int4_kernel_takes("v3", M, half, N, t4.group)
    x = _rand((M, K), 91)
    dtype = torch.bfloat16 if bf16 else torch.float32
    want = jqm.int4_matmul(
        jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32), j4)
    xp = torch.nn.functional.pad(_t(x, dtype), (0, 2 * half - K))
    got = tqm.INT4_FALLBACK["v1"](xp, t4.q, t4.scale, t4.group)
    assert got.dtype == dtype
    _check(got, want, bf16)
    assert tqm.INT4_FALLBACK["v3"] is tqm.INT4_FALLBACK["v1"]


@pytest.mark.parametrize("M,K,N", [(4, 1024, 40), (1, 96, 40), (32, 176, 24)])
def test_w4a8_fallback_matches_jax(monkeypatch, one_device, M, K, N):
    """W4A8 outside its GEMV's domain (N % 16 != 0) against the JAX
    dispatcher's ``_int4_w4a8_xla``."""
    j4, t4 = _pair(K, N, 92 + K)
    half = t4.q.shape[0]
    assert not tqm.int4_kernel_takes("w4a8", M, half, N, t4.group)
    x = _rand((M, K), 93)
    monkeypatch.setattr(jqm, "W4A8_DECODE", True)
    want = jqm.int4_matmul(jnp.asarray(x), j4)
    xp = torch.nn.functional.pad(_t(x), (0, 2 * half - K))
    got = tqm.INT4_FALLBACK["w4a8"](xp, t4.q, t4.scale, t4.group)
    _check(got, want, bf16=False)


@pytest.mark.parametrize("M,K,N", [(300, 96, 64), (256, 1024, 40),
                                   (260, 176, 48)])
def test_w8a8p_fallback_matches_jax(monkeypatch, one_device, M, K, N):
    """W8A8 prefill outside its tile's domain (group 16 and 8, N % 16 !=
    0) against the JAX dispatcher's ``_int4_w8a8p_xla``, bit for bit."""
    j4, t4 = _pair(K, N, 94 + K)
    half = t4.q.shape[0]
    assert not tqm.int4_kernel_takes("w8a8p", M, half, N, t4.group)
    x = _rand((M, K), 95)
    monkeypatch.setattr(jqm, "W8A8_PREFILL", True)
    want = jqm.int4_matmul(jnp.asarray(x), j4)
    xp = torch.nn.functional.pad(_t(x), (0, 2 * half - K))
    got = tqm.INT4_FALLBACK["w8a8p"](xp, t4.q, t4.scale, t4.group)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("M,K,N", [(4, 1024, 40), (40, 100, 64),
                                   (300, 97, 48)])
@pytest.mark.parametrize("bf16", [False, True])
def test_int8_dense_fallback_matches_jax(one_device, M, K, N, bf16):
    """int8 outside its kernel's domain (N % 16 != 0; K % 8 != 0 above 32
    rows) against the JAX dispatcher's ``x @ (q * scale).astype(x.dtype)``."""
    j8, t8 = _pair(K, N, 96 + K, bits=8)
    assert not tqm.int8_kernel_takes(M, K, N)
    x = _rand((M, K), 97)
    dtype = torch.bfloat16 if bf16 else torch.float32
    want = jqm.int8_matmul(
        jnp.asarray(x).astype(jnp.bfloat16 if bf16 else jnp.float32), j8)
    got = tqm.int8_matmul_dense(_t(x, dtype), t8.q, t8.scale)
    assert got.dtype == dtype
    _check(got, want, bf16)


def test_ffn_down_fallback_matches_jax(one_device):
    """The fused FFN tail outside its kernel's domain (the tiny decoder's
    w2: K 176, group 8, at 40 rows) takes the unfused ops, as the JAX
    function does off the TPU: res + int4_matmul(silu(g) * u)."""
    j4, t4 = _pair(176, 64, 98)
    assert not tqm.int4_kernel_takes("glu", 40, t4.q.shape[0], 64, t4.group)
    g, u, res = _rand((40, 176), 99), _rand((40, 176), 100), _rand((40, 64),
                                                                    101)
    want = jqm.int4_ffn_down(jnp.asarray(g), jnp.asarray(u), j4,
                             jnp.asarray(res))
    xp = torch.nn.functional.pad(
        torch.nn.functional.silu(_t(g)) * _t(u), (0, 2 * t4.q.shape[0] - 176))
    got = _t(res) + tqm.INT4_FALLBACK["v1"](xp, t4.q, t4.scale, t4.group)
    _check(got, want, bf16=False)


def test_fallback_counters_reset():
    tqm.int4_matmul.fallbacks["v1"] += 2
    tqm.int8_matmul.fallbacks += 1
    assert tqm.fallback_count() >= 3
    tqm.reset_fallbacks()
    assert tqm.fallback_count() == 0
    assert set(tqm.int4_matmul.fallbacks) == {"v1", "v3", "w4a8", "w8a8p",
                                              "glu"}
