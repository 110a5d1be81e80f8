"""The quantized-matmul modes of the PyTorch port against the JAX package on
the CPU: int8 decoder weights, W4A8 decode, W8A8 prefill, W8A8 towers, the
GLU-fused FFN tail and the v3 int4 variant. Inputs come from a numpy seed
and go to both packages; the JAX kernels run in Pallas interpret mode, as
the JAX package's own tests run them, or through their XLA emulations.

Tolerances, each with its reason:

- quantizers (``quantize_act_int8``, ``_quantize_leaf_int8``,
  ``quantize_tower_params``, ``quantize_params``): bit-identical. Both sides
  take the true float32 quotient and round half to even.
- K6, K7 plain versions against the Pallas kernels in float32: 1e-5
  (exact products, float32 sums in another order). K6 in bf16: 2^-6 (each
  side rounds once to bf16, and the JAX fallback folds the scale into a
  bf16 weight first).
- K8: bit-identical to ``_int4_w8a8p_xla`` (integer sums are exact and the
  epilogue has one order); 1e-6 against the Pallas kernel in interpret
  mode, which is what the JAX package's own test holds those two to (XLA
  may reassociate the interpreted kernel's two epilogue products).
- K11 and K1v3 in float32: 1e-4 (float32 sums in another order, and for K11
  the sigmoid's rounding); K11 in bf16: 2^-6 (one bf16 rounding each side).
- the slice (``MetaModel``) in each mode: image tokens and prefill logits
  1e-4 as in ``test_torch_slice.py`` (float32, byte-identical quantized
  weights, and in the A8 modes byte-identical int8 activations wherever
  the float32 inputs agree to the last bit of a rounding tie); greedy ids
  identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.ops import quant_matmul as jqm
from a3vlm_tpu_torch import quant as tquant
from a3vlm_tpu_torch.checkpoint.bridge import (
    params_from_numpy,
    params_to_numpy,
)
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import ens5 as tens5
from a3vlm_tpu_torch.models import llama as tllama
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


def _int4_pair(K, N, seed):
    w = _rand((K, N), seed, 0.05)
    return jquant._quantize_leaf_int4(w), tquant._quantize_leaf_int4(_t(w))


def _int8_pair(K, N, seed):
    w = _rand((K, N), seed, 0.05)
    return jquant._quantize_leaf_int8(w), tquant._quantize_leaf_int8(_t(w))


def _assert_same_leaf(t, j):
    np.testing.assert_array_equal(t.q.numpy(), np.asarray(j.q))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    assert (t.bits, t.group, t.in_dim) == (j.bits, j.group, j.in_dim)


def _check_bf16(got, want):
    got, want = _np(got), _np(want)
    bound = BF16_RTOL * np.abs(want) + 1e-3 * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), np.abs(got - want).max()


@pytest.fixture
def one_device(monkeypatch):
    """The JAX dispatchers read their mode flags on the single-device path
    only; the tests run on a forced 8-device CPU mesh, so pin the count the
    dispatchers see, as the JAX package's own tests do."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])


# ------------------------------------------------------------- quantizers
@pytest.mark.parametrize("shape,scale", [((5, 64), 1.0), ((1, 1024), 30.0),
                                         ((33, 200), 1e-3)])
def test_quantize_act_int8_bit_identical(shape, scale):
    x = _rand(shape, 1, scale)
    x[0, :3] = 0.0
    jq, js = jqm.quantize_act_int8(jnp.asarray(x))
    tq, ts = tqm.quantize_act_int8(_t(x))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.dtype == torch.int8 and ts.shape == (shape[0], 1)
    zq, zs = tqm.quantize_act_int8(torch.zeros(2, 8))
    assert float(zq.abs().max()) == 0 and float(zs[0, 0]) == np.float32(
        1e-8) / np.float32(127.0)


@pytest.mark.parametrize("shape", [(64, 48), (3, 96, 40), (65, 16)])
def test_quantize_leaf_int8_bit_identical(shape):
    w = _rand(shape, 2, 0.05)
    j, t = jquant._quantize_leaf_int8(w), tquant._quantize_leaf_int8(_t(w))
    _assert_same_leaf(t, j)
    assert t.scale.shape == (*shape[:-2], 1, shape[-1])
    np.testing.assert_array_equal(
        tquant._dequantize_leaf(t, torch.float32).numpy(),
        np.asarray(jquant._dequantize_leaf(j, jnp.float32)))
    if len(shape) == 3:
        _assert_same_leaf(t.layer(1), jquant.QuantizedWeight(
            j.q[1], j.scale[1], 8))


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_same_leaves(bits):
    """Same leaves quantized, to the same bytes; under bits=4 the weight
    with an odd input dim becomes int8; embeddings, norms and biases stay
    dense."""
    tree = {
        "tok_embeddings": {"weight": _rand((32, 16), 3)},
        "layers": {"attention": {"wq": {"weight": _rand((2, 16, 24), 4),
                                        "bias": _rand((2, 24), 5)}},
                   "attention_norm": {"weight": _rand((2, 16), 6)}},
        "odd": {"weight": _rand((15, 8), 7)},
        "output": {"weight": _rand((16, 32), 8)},
    }
    j = jquant.quantize_params({"m": tree}, bits=bits)["m"]
    t = tquant.quantize_params({"m": params_from_numpy(tree, device="cpu")},
                               bits=bits)["m"]
    wq = t["layers"][0]["attention"]["wq"]
    assert isinstance(wq["weight"], tquant.QuantizedWeight)
    assert wq["weight"].bits == bits and t["odd"]["weight"].bits == 8
    jw = j["layers"]["attention"]["wq"]["weight"]
    for i in range(2):
        _assert_same_leaf(t["layers"][i]["attention"]["wq"]["weight"],
                          jquant.QuantizedWeight(jw.q[i], jw.scale[i], bits,
                                                 jw.group, jw.in_dim))
    _assert_same_leaf(t["odd"]["weight"], j["odd"]["weight"])
    _assert_same_leaf(t["output"]["weight"], j["output"]["weight"])
    assert isinstance(t["tok_embeddings"]["weight"], torch.Tensor)
    assert isinstance(wq["bias"], torch.Tensor)
    assert isinstance(t["layers"][1]["attention_norm"]["weight"],
                      torch.Tensor)
    mask = tquant.freeze_quantized_mask(
        t, tquant.tree_map(lambda _: True, t))
    assert mask["odd"]["weight"] is False
    assert mask["tok_embeddings"]["weight"] is True


# ---------------------------------------------------------------- kernels
@pytest.mark.parametrize("M,K,N", [(4, 1024, 256), (40, 512, 1152),
                                   (3, 256, 200)])
def test_int8_plain_matches_pallas_f32(M, K, N):
    """K6, float32; N = 1152 and 200 do not divide the Pallas block."""
    j8, t8 = _int8_pair(K, N, 10)
    x = _rand((M, K), 11)
    want = jqm._int8_matmul_2d(jnp.asarray(x), j8.q, j8.scale.reshape(1, -1),
                               interpret=True)
    got = tqm.int8_matmul_2d(_t(x), t8.q, t8.scale)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)
    dense = x @ (np.asarray(j8.q, np.float32) * np.asarray(j8.scale))
    np.testing.assert_allclose(got.numpy(), dense, atol=1e-4, rtol=1e-4)
    # the dispatcher over leading dims, and the JAX fallback's association
    got3 = tqm.int8_matmul(_t(x).reshape(1, M, K), t8)
    assert got3.shape == (1, M, N)
    np.testing.assert_array_equal(got3[0].numpy(), got.numpy())
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jqm.int8_matmul(jnp.asarray(x), j8)),
        atol=1e-5, rtol=1e-5)


def test_int8_plain_matches_pallas_bf16():
    j8, t8 = _int8_pair(1024, 256, 12)
    x = _rand((8, 1024), 13)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    got = tqm.int8_matmul_2d(_t(x, torch.bfloat16), t8.q, t8.scale)
    assert got.dtype == torch.bfloat16
    _check_bf16(got, jqm._int8_matmul_2d(xb, j8.q, j8.scale.reshape(1, -1),
                                         interpret=True))
    _check_bf16(got, jqm.int8_matmul(xb, j8))


@pytest.mark.parametrize("M", [1, 8, 32])
def test_w4a8_plain_matches_pallas(M):
    """K7 against the Pallas kernel and the XLA emulation."""
    j4, t4 = _int4_pair(2048, 256, 20)
    x = _rand((M, 2048), 21 + M)
    got = tqm.int4_matmul_2d_w4a8(_t(x), t4.q, t4.scale, t4.group).numpy()
    want = jqm._int4_matmul_2d_w4a8(jnp.asarray(x), j4.q, j4.scale,
                                    group=j4.group, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(
        got, np.asarray(jqm._int4_w4a8_xla(jnp.asarray(x), j4)), atol=1e-5,
        rtol=1e-5)
    exact = tqm.int4_matmul_2d_plain(_t(x), t4.q, t4.scale, t4.group).numpy()
    assert not np.array_equal(got, exact)
    assert np.linalg.norm(got - exact) / np.linalg.norm(exact) < 0.01


@pytest.mark.parametrize("M", [256, 261])
def test_w8a8p_plain_bit_identical(M):
    """K8: bit for bit the XLA emulation; the Pallas kernel to 1e-6."""
    j4, t4 = _int4_pair(2048, 256, 30)
    x = _rand((M, 2048), 31 + M)
    got = tqm.int4_matmul_2d_w8a8p(_t(x), t4.q, t4.scale, t4.group).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jqm._int4_w8a8p_xla(jnp.asarray(x), j4)))
    want = jqm._int4_matmul_2d_w8a8p(jnp.asarray(x), j4.q, j4.scale,
                                     group=j4.group, interpret=True)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6, rtol=1e-6)
    ratio, cs = tqm.w8a8p_factors(t4.scale)
    w8 = tqm.requantize_w8(t4.q, ratio, t4.group)
    assert w8.dtype == torch.int8 and int(w8.abs().max()) <= 127
    assert ratio.shape == t4.scale.shape and cs.shape == (1, 256)
    # bf16 activations round once more at the store
    xb = _t(x, torch.bfloat16)
    _check_bf16(tqm.int4_matmul_2d_w8a8p(xb, t4.q, t4.scale, t4.group),
                jqm._int4_w8a8p_xla(jnp.asarray(x).astype(jnp.bfloat16), j4))


@pytest.mark.parametrize("M", [2, 40])
def test_glu_plain_matches_pallas(M):
    """K11. float32 against ``int4_ffn_down`` (1e-4), which off the TPU is
    the unfused float32 math. The Pallas kernel rounds silu(g) * u and the
    weights to bf16 whatever its inputs' type, so it is held in bf16, the
    only type the CUDA kernel takes: 2^-6 with bf16 outputs, and 2e-3 with a
    float32 residual and output, where nothing rounds after the sum (a
    sigmoid that differs in its last bit can move one element of z across a
    bf16 rounding tie, 2^-8 of |z| times a weight of ~0.1)."""
    j4, t4 = _int4_pair(1024, 256, 40)
    g, u = _rand((M, 1024), 41), _rand((M, 1024), 42)
    res = _rand((M, 256), 43)
    got = tqm.int4_ffn_down(_t(g), _t(u), t4, _t(res))
    want = jqm.int4_ffn_down(jnp.asarray(g), jnp.asarray(u), j4,
                             jnp.asarray(res))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    bf = torch.bfloat16
    gb, ub, rb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (g, u, res))

    def pallas(r):
        return jqm._int4_matmul_2d_glu(gb, ub, j4.q, j4.scale, r,
                                       group=j4.group, interpret=True)

    got_b = tqm.int4_matmul_2d_glu(_t(g, bf), _t(u, bf), t4.q, t4.scale,
                                   _t(res, bf), t4.group)
    assert got_b.dtype == bf
    _check_bf16(got_b, pallas(rb))
    got_f = tqm.int4_matmul_2d_glu(_t(g, bf), _t(u, bf), t4.q, t4.scale,
                                   _t(res), t4.group)
    assert got_f.dtype == torch.float32
    np.testing.assert_allclose(got_f.numpy(),
                               np.asarray(pallas(jnp.asarray(res))),
                               atol=2e-3, rtol=0)


def test_glu_pads_k():
    """An input dim the packer pads (1100 -> 2048): g and u are padded."""
    j4, t4 = _int4_pair(1100, 128, 44)
    g, u, res = _rand((3, 1100), 45), _rand((3, 1100), 46), _rand((3, 128), 47)
    got = tqm.int4_ffn_down(_t(g), _t(u), t4, _t(res), impl="plain")
    want = jnp.asarray(res) + jqm._int4_matmul_xla(
        jnp.pad(jax.nn.silu(jnp.asarray(g)) * jnp.asarray(u),
                ((0, 0), (0, 2048 - 1100))), j4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("M", [4, 40])
def test_v3_plain_matches_pallas(M):
    """K1v3 against the Pallas v3 kernel, and against the v1 math."""
    j4, t4 = _int4_pair(2048, 256, 50)
    x = _rand((M, 2048), 51)
    got = tqm.int4_matmul_2d(_t(x), t4.q, t4.scale, t4.group, variant="v3")
    want = jqm._int4_matmul_2d(jnp.asarray(x), j4.q, j4.scale,
                               group=j4.group, interpret=True, variant="v3")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    v1 = tqm.int4_matmul_2d(_t(x), t4.q, t4.scale, t4.group, variant="v1")
    np.testing.assert_allclose(got.numpy(), v1.numpy(), atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(
        tqm.int4_matmul_2d_v3(_t(x), t4.q, t4.scale, t4.group).numpy(),
        got.numpy())
    with pytest.raises(ValueError):
        tqm.int4_matmul_2d(_t(x), t4.q, t4.scale, t4.group, variant="v2")


def test_dispatcher_routes_by_m(monkeypatch, one_device):
    """W4A8 only for M <= 32, W8A8P only for M >= 256, each the JAX
    dispatcher's result; with the flags off, K1's result exactly."""
    j4, t4 = _int4_pair(2048, 256, 60)
    xs = {M: _rand((M, 2048), 61 + M) for M in (4, 32, 33, 255, 256)}
    exact = {M: tqm.int4_matmul(_t(x), t4) for M, x in xs.items()}
    for M, x in xs.items():
        np.testing.assert_array_equal(
            exact[M].numpy(),
            tqm.int4_matmul_2d_plain(_t(x), t4.q, t4.scale, t4.group).numpy())
    jax.clear_caches()
    for mod in (jqm, tqm):
        monkeypatch.setattr(mod, "W4A8_DECODE", True)
        monkeypatch.setattr(mod, "W8A8_PREFILL", True)
    try:
        for M, x in xs.items():
            got = tqm.int4_matmul(_t(x).reshape(1, M, 2048), t4)[0]
            assert torch.equal(got, tqm.int4_matmul(_t(x), t4, impl="plain"))
            want = np.asarray(jqm.int4_matmul(jnp.asarray(x), j4))
            if M <= 32:
                assert torch.equal(got, tqm.int4_matmul_2d_w4a8_plain(
                    _t(x), t4.q, t4.scale, t4.group))
                np.testing.assert_allclose(got.numpy(), want, atol=1e-5,
                                           rtol=1e-5)
            elif M >= 256:
                assert torch.equal(got, tqm.int4_matmul_2d_w8a8p_plain(
                    _t(x), t4.q, t4.scale, t4.group))
                np.testing.assert_array_equal(got.numpy(), want)
            else:
                assert torch.equal(got, exact[M])
        # eager: a flag flips at the next call
        monkeypatch.setattr(tqm, "W8A8_PREFILL_MIN_M", 33)
        assert torch.equal(
            tqm.int4_matmul(_t(xs[33]), t4),
            tqm.int4_matmul_2d_w8a8p_plain(_t(xs[33]), t4.q, t4.scale,
                                           t4.group))
    finally:
        jax.clear_caches()
    with pytest.raises(ValueError):
        tqm.int4_matmul(_t(xs[4])[:, :100], t4)


def test_auto_variant_is_read_at_call(monkeypatch):
    j4, t4 = _int4_pair(1024, 128, 70)
    x = _t(_rand((4, 1024), 71))
    monkeypatch.setattr(tqm, "_AUTO_VARIANT", "v3")
    assert torch.equal(tqm.int4_matmul(x, t4),
                       tqm.int4_matmul_2d_v3_plain(x, t4.q, t4.scale,
                                                   t4.group))
    assert torch.equal(tqm.int4_matmul(x, t4, variant="v1"),
                       tqm.int4_matmul_2d_plain(x, t4.q, t4.scale, t4.group))
    assert torch.equal(tqm.int4_matmul(x, t4, impl="plain"),
                       tqm.int4_matmul(x, t4))


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Wrappers raise on operands the kernels cannot take and never fall
    back: here shape errors that are checked before the device is."""
    _, t4 = _int4_pair(1024, 128, 72)
    x = _t(_rand((4, 1024), 73))
    meta = torch.device("meta")
    xm = torch.empty((4, 1024), dtype=torch.bfloat16, device=meta)
    qm_ = torch.empty((512, 120), dtype=torch.int8, device=meta)
    sm = torch.empty((32, 120), dtype=torch.float32, device=meta)
    for fn in (tqm.int4_matmul_2d, tqm.int4_matmul_2d_v3,
               tqm.int4_matmul_2d_w4a8, tqm.int4_matmul_2d_w8a8p):
        with pytest.raises(ValueError, match="multiple of 16"):
            fn(xm, qm_, sm, 32)
    with pytest.raises(ValueError, match="multiple of 16"):
        tqm.int8_matmul_2d(xm, torch.empty((1024, 120), dtype=torch.int8,
                                           device=meta),
                           torch.empty((1, 120), device=meta))
    with pytest.raises(ValueError, match="int8"):
        tqm.w8a8_matmul(x, t4)
    for fn in (tqm.int4_matmul_2d, tqm.int4_matmul_2d_v3,
               tqm.int4_matmul_2d_glu, tqm.int4_matmul_2d_w4a8,
               tqm.int4_matmul_2d_w8a8p, tqm.int8_matmul_2d):
        assert fn.launches == 0  # nothing launches on the CPU


# ------------------------------------------------------- W8A8 for towers
@pytest.mark.parametrize("lead", [(7,), (2, 9)])
def test_w8a8_matmul_matches_jax(lead):
    j8, t8 = _int8_pair(96, 40, 80)
    x = _rand((*lead, 96), 81)
    got = tqm.w8a8_matmul(_t(x), t8)
    want = jqm.w8a8_matmul(jnp.asarray(x), j8)
    assert got.shape == (*lead, 40)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    a = _t(np.random.default_rng(1).integers(-127, 128, (5, 2500)),
           torch.int8)
    b = _t(np.random.default_rng(2).integers(-127, 128, (2500, 6)),
           torch.int8)
    assert torch.equal(tqm._int_dot(a, b).long(), a.long() @ b.long())


def test_quantize_tower_params_matches_jax():
    """Same leaves, byte-identical q and scale; then the towers' features
    through both packages' W8A8 path."""
    jcfg = jens5.tiny_ens5_config()
    jparams = jens5.init_ens5_params(jax.random.PRNGKey(3), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    jq = jens5.quantize_tower_params(jparams)
    tq = tens5.quantize_tower_params(params_from_numpy(tree, device="cpu"))
    assert tens5.W8A8_TOWER_KEYS == jens5.W8A8_TOWER_KEYS

    def walk(t, j, path):
        if isinstance(j, jquant.QuantizedWeight):
            assert isinstance(t, tquant.QuantizedWeight), path
            _assert_same_leaf(t, j)
            return 1
        if isinstance(t, dict):
            return sum(walk(t[k], j[k], path + (k,)) for k in t)
        if isinstance(t, list):
            return sum(walk(a, b, path + (i,))
                       for i, (a, b) in enumerate(zip(t, j)))
        assert not isinstance(t, tquant.QuantizedWeight), path
        return 0

    n = sum(walk(tq[k], jq[k], (k,)) for k in tq if k != "llama")
    assert n >= 4 * 4  # four linears per ViT block stack, pw1/pw2 per stage
    assert isinstance(tq["qformer_proj"]["linear"]["weight"], torch.Tensor)
    images = _rand((1, jcfg.image_size, jcfg.image_size, 3), 82)
    want = jens5.build_image_tokens(jq, jcfg, jnp.asarray(images))
    got = tens5.build_image_tokens(tq, tiny_ens5_config(), _t(images))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=0)
    dense = tens5.build_image_tokens(params_from_numpy(tree, device="cpu"),
                                     tiny_ens5_config(), _t(images))
    assert not torch.equal(got, dense)


# ------------------------------------------------------ gradients, bridge
def test_qmat_int8_gradient_matches_jax_vjp():
    j8, t8 = _int8_pair(64, 48, 90)
    x = _rand((5, 64), 91)
    ct = _rand((5, 48), 92)
    y, vjp = jax.vjp(lambda a: jqm.qmat(a, j8), jnp.asarray(x))
    (jdx,) = vjp(jnp.asarray(ct))
    tx = _t(x).requires_grad_()
    ty = tqm.qmat(tx, t8)
    ty.backward(_t(ct))
    np.testing.assert_allclose(ty.detach().numpy(), np.asarray(y), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jdx), atol=1e-5,
                               rtol=1e-5)
    # a LoRA side path over the int8 base
    a, b = _t(_rand((64, 4), 93)), _t(_rand((4, 48), 94))
    lw = tquant.LoraWeight(t8, a.requires_grad_(), b.requires_grad_())
    out = tqm.qmat(_t(x), lw)
    jout = jqm.qmat(jnp.asarray(x), jquant.LoraWeight(
        j8, jnp.asarray(a.detach().numpy()), jnp.asarray(b.detach().numpy())))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout),
                               atol=1e-4, rtol=1e-4)
    out.sum().backward()
    assert a.grad is not None and float(a.grad.abs().max()) > 0


def test_bridge_int8_both_ways():
    cfg = jens5.tiny_ens5_config()
    jp = jllama.init_llama_params(jax.random.PRNGKey(5), cfg.llama)
    jp8 = jquant.quantize_params(jp, bits=8)
    tree = jax.tree_util.tree_map(np.asarray, jp8)
    tp = params_from_numpy(tree, device="cpu")
    jw = jp8["layers"]["feed_forward"]["w2"]["weight"]
    for i, layer in enumerate(tp["layers"]):
        _assert_same_leaf(layer["feed_forward"]["w2"]["weight"],
                          jquant.QuantizedWeight(jw.q[i], jw.scale[i], 8))
    _assert_same_leaf(tp["output"]["weight"], jp8["output"]["weight"])
    back = params_to_numpy(tp)
    w = back["layers"]["feed_forward"]["w2"]["weight"]
    np.testing.assert_array_equal(w.q, np.asarray(jw.q))
    np.testing.assert_array_equal(w.scale, np.asarray(jw.scale))
    assert (w.bits, w.group, w.in_dim) == (8, 0, 0)
    again = params_from_numpy(back, device="cpu")
    _assert_same_leaf(again["layers"][1]["feed_forward"]["w2"]["weight"],
                      tp["layers"][1]["feed_forward"]["w2"]["weight"])


@pytest.mark.parametrize("shape", [(2048, 16), (3, 1024, 8)])
def test_bridge_repacks_chunked_int4(shape):
    """A k_chunks = 2 leaf crosses as k_chunks = 1 with the dense weight of
    JAX's ``_dequantize_leaf`` bit for bit, and multiplies like it."""
    w = _rand(shape, 95, 0.05)
    chunked = jquant._quantize_leaf_int4(w, k_chunks=2)
    assert chunked.k_chunks == 2
    leaf = params_from_numpy(
        {"w": jax.tree_util.tree_map(np.asarray, chunked)}, device="cpu")["w"]
    K = shape[-2]
    assert leaf.q.shape == (*shape[:-2], K // 2, shape[-1])
    assert leaf.scale.shape == (*shape[:-2], K // chunked.group, shape[-1])
    assert (leaf.bits, leaf.group, leaf.in_dim) == (4, chunked.group, K)
    np.testing.assert_array_equal(
        tquant._dequantize_leaf(leaf, torch.float32).numpy(),
        np.asarray(jquant._dequantize_leaf(chunked, jnp.float32)))
    if len(shape) == 2:
        x = _rand((3, K), 96)
        np.testing.assert_allclose(
            tqm.int4_matmul(_t(x), leaf).numpy(),
            np.asarray(jqm.int4_matmul(jnp.asarray(x), chunked)), atol=1e-5,
            rtol=1e-5)


# ------------------------------------------------------------ the slice
MODES = ("int8", "w4a8_w8a8p", "fuse_ffn_down", "v3", "tower_bits8")


class _Recording:
    """Tokenizer proxy that records the id lists passed to decode."""

    def __init__(self, tok):
        self._tok = tok
        self.decoded = []

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self._tok.decode(ids)

    def __getattr__(self, name):
        return getattr(self._tok, name)


@pytest.fixture(scope="module")
def setup(tiny_tokenizer):
    vocab = -(-tiny_tokenizer.n_words // 128) * 128
    jcfg = jens5.tiny_ens5_config(vocab_size=vocab)
    jparams = jens5.init_ens5_params(jax.random.PRNGKey(11), jcfg)
    return {
        "tok": tiny_tokenizer, "jcfg": jcfg, "tcfg": tiny_ens5_config(vocab),
        "jparams": jparams,
        "tree": jax.tree_util.tree_map(np.asarray, jparams),
        "images": _rand((2, jcfg.image_size, jcfg.image_size, 3), 12),
    }


def _set_mode(monkeypatch, mode):
    """Switch ``mode`` on in both packages. The JAX flags are read when a
    function is traced, so the caches are dropped around the test."""
    if mode == "w4a8_w8a8p":
        for mod in (jqm, tqm):
            monkeypatch.setattr(mod, "W4A8_DECODE", True)
            monkeypatch.setattr(mod, "W8A8_PREFILL", True)
            # the tiny prefill has 2 x (bucket + 135) rows: over 33
            monkeypatch.setattr(mod, "W8A8_PREFILL_MIN_M", 33)
    elif mode == "fuse_ffn_down":
        monkeypatch.setattr(jllama, "FUSE_FFN_DOWN", True)
        monkeypatch.setattr(tllama, "FUSE_FFN_DOWN", True)
    elif mode == "v3":
        monkeypatch.setattr(jqm, "_AUTO_VARIANT", "v3")
        monkeypatch.setattr(tqm, "_AUTO_VARIANT", "v3")


def _quantize(model, mode):
    if mode == "int8":
        model.quantize(bits=8)
    elif mode == "tower_bits8":
        model.quantize(bits=4, tower_bits=8)
    else:
        model.quantize(bits=4)


@pytest.mark.parametrize("mode", MODES)
def test_slice_matches_jax_in_mode(setup, mode, monkeypatch, one_device):
    """``MetaModel`` in each quantized mode: image tokens and prefill
    logits within 1e-4 of the JAX ``MetaModel`` in the same mode, one
    decode step too, and identical greedy ids over 10 new tokens."""
    jax.clear_caches()
    _set_mode(monkeypatch, mode)
    tok = setup["tok"]
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jrec, trec = _Recording(tok), _Recording(tok)
    try:
        jmodel = JMetaModel(
            "llama_ens5", with_visual=True, max_seq_len=512,
            dtype=jnp.float32, params=setup["jparams"], tokenizer=jrec,
            model_cfg=jcfg)
        _quantize(jmodel, mode)
        tmodel = MetaModel(
            "llama_ens5", with_visual=True, max_seq_len=512,
            params=params_from_numpy(setup["tree"], device="cpu"),
            tokenizer=trec,
            model_cfg=dataclasses.replace(tcfg))
        _quantize(tmodel, mode)
        wq = tmodel.params["llama"]["layers"][0]["attention"]["wq"]["weight"]
        assert wq.bits == (8 if mode == "int8" else 4)
        clip_w = tmodel.params["clip"]["blocks"]["attn"]["wqkv"]["weight"]
        assert isinstance(clip_w, tquant.QuantizedWeight) == (
            mode == "tower_bits8")

        images = setup["images"]
        want_img = jmodel.encode_images(jnp.asarray(images))
        got_img = tmodel.encode_images(torch.tensor(images))
        np.testing.assert_allclose(got_img.numpy(), np.asarray(want_img),
                                   atol=1e-4, rtol=0)

        tokens = np.random.default_rng(13).integers(3, 300, size=(2, 9))
        tokens[:, 0] = 1
        S = 9 + jcfg.image_words
        jp = jllama.unstack_layers(jmodel.params["llama"])
        tp = tmodel.params["llama"]
        jcache = jllama.KVCache.create(jcfg.llama, 2, max_seq_len=S + 1,
                                       dtype=jnp.float32, layered=True)
        want, jcache, _ = jllama.prefill(jp, jcfg.llama, jcache,
                                         jnp.asarray(tokens),
                                         image_tokens=want_img)
        tcache = tllama.KVCache.create(tcfg.llama, 2, max_seq_len=S + 1,
                                       dtype=torch.float32, device="cpu")
        got, tcache, n = tllama.prefill(tp, tcfg.llama, tcache,
                                        torch.tensor(tokens),
                                        image_tokens=got_img)
        assert n == S
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        nxt = np.array([[5], [6]])
        want_d, _ = jllama.decode_step(jp, jcfg.llama, jcache,
                                       jnp.asarray(nxt), S)
        got_d, _ = tllama.decode_step(tp, tcfg.llama, tcache,
                                      torch.tensor(nxt), S)
        np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d),
                                   atol=1e-4, rtol=0)
        if mode in ("w4a8_w8a8p", "tower_bits8"):
            # the mode is on: not the exact int4 path's numbers
            exact = MetaModel(
                "llama_ens5", with_visual=True, max_seq_len=512,
                params=params_from_numpy(setup["tree"], device="cpu"),
                tokenizer=tok,
                model_cfg=dataclasses.replace(tcfg))
            exact.quantize(bits=4)
            if mode == "tower_bits8":
                assert not torch.equal(
                    exact.encode_images(torch.tensor(images)), got_img)
            else:
                monkeypatch.setattr(tqm, "W4A8_DECODE", False)
                monkeypatch.setattr(tqm, "W8A8_PREFILL", False)
                c = tllama.KVCache.create(tcfg.llama, 2, max_seq_len=S + 1,
                                          dtype=torch.float32, device="cpu")
                ex, _, _ = tllama.prefill(exact.params["llama"], tcfg.llama,
                                          c, torch.tensor(tokens),
                                          image_tokens=got_img)
                assert not torch.equal(ex, got)
                monkeypatch.setattr(tqm, "W4A8_DECODE", True)
                monkeypatch.setattr(tqm, "W8A8_PREFILL", True)

        prompts = ["### Human: please provide the joint's type",
                   "detect all manipulable object parts and provide their "
                   "rotated bounding boxes"]
        want_text = jmodel.generate(prompts, images=images, max_gen_len=10)
        got_text = tmodel.generate(prompts, images=torch.tensor(images),
                                   max_gen_len=10)
        assert trec.decoded == jrec.decoded
        assert got_text == want_text
        assert max(len(ids) for ids in trec.decoded) >= 8
    finally:
        jax.clear_caches()


def test_finetune_accepts_int8_base(setup):
    """``qlora_trainable_mask`` and the adapters over an int8 base: the
    base freezes, the adapter spans the dense weight's shape."""
    from a3vlm_tpu_torch.main_finetune import qlora_trainable_mask
    from a3vlm_tpu_torch.train.lora import attach_lora, init_lora_params

    tmodel = MetaModel(
        "llama_ens5", with_visual=True, max_seq_len=512,
        params=params_from_numpy(setup["tree"], device="cpu"),
        tokenizer=setup["tok"],
        model_cfg=dataclasses.replace(setup["tcfg"]))
    tmodel.quantize(bits=8)
    gen = torch.Generator().manual_seed(0)
    lora = init_lora_params(gen, tmodel.params["llama"], rank=4)
    w2 = tmodel.params["llama"]["layers"][0]["feed_forward"]["w2"]["weight"]
    ab = lora["layers"][0]["feed_forward"]["w2"]
    assert ab["a"].shape == (w2.q.shape[0], 4)
    assert ab["b"].shape == (4, w2.q.shape[1])
    mask = qlora_trainable_mask(tmodel, lora, quant=True)
    assert mask["llama"]["layers"][0]["feed_forward"]["w2"]["weight"] is False
    attached = attach_lora(tmodel.params["llama"], lora)
    x = _t(_rand((2, 3, w2.q.shape[0]), 14)).requires_grad_()
    out = tqm.qmat(x, attached["layers"][0]["feed_forward"]["w2"]["weight"])
    out.sum().backward()
    assert x.grad is not None and torch.isfinite(x.grad).all()
