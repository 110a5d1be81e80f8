"""The PyTorch port's plain ops against the JAX package's, on the same
numpy inputs: norms, RoPE, attention masks, resize, top-p filtering, int4
packing, configs and the weight bridge. Also: importing the port never
imports JAX."""

import dataclasses
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.models import convnext as jconvnext
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import qformer as jqformer
from a3vlm_tpu.models import vit as jvit
from a3vlm_tpu.ops import norms as jnorms
from a3vlm_tpu.ops.attention import (
    right_aligned_causal_mask as j_causal_mask,
    sdpa_reference as j_sdpa_reference,
)
from a3vlm_tpu.ops import rope as jrope
from a3vlm_tpu.ops import sampling as jsampling
from a3vlm_tpu_torch import config as tconfig
from a3vlm_tpu_torch import quant as tquant
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.ops import attention as tattn
from a3vlm_tpu_torch.ops import norms as tnorms
from a3vlm_tpu_torch.ops import resize as tresize
from a3vlm_tpu_torch.ops import rope as trope
from a3vlm_tpu_torch.ops import sampling as tsampling

torch.set_num_threads(1)
ATOL = 1e-5


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def test_port_imports_no_jax():
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        import a3vlm_tpu_torch
        names = [m.name for m in pkgutil.walk_packages(
            a3vlm_tpu_torch.__path__, "a3vlm_tpu_torch.")]
        for name in names:
            importlib.import_module(name)
        assert {"a3vlm_tpu_torch.meta", "a3vlm_tpu_torch.models.ens5",
                "a3vlm_tpu_torch.checkpoint.bridge"} <= set(names), names
        bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")]
        assert not bad, bad
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_norms_match():
    x, w, b = _rand((3, 5, 16), 0), _rand((16,), 1), _rand((16,), 2)
    _close(tnorms.rms_norm(torch.tensor(x), torch.tensor(w), 1e-5),
           jnorms.rms_norm(jnp.asarray(x), jnp.asarray(w), 1e-5))
    _close(tnorms.layer_norm(torch.tensor(x), torch.tensor(w),
                             torch.tensor(b), 1e-6),
           jnorms.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                             1e-6))


@pytest.mark.parametrize("scaling", [None, 4.0])
def test_rope_matches(scaling):
    table_t = trope.precompute_freqs_cis(16, 64, scaling=scaling, device="cpu")
    table_j = jrope.precompute_freqs_cis(16, 64, scaling=scaling)
    _close(table_t, table_j)
    xq, xk = _rand((2, 7, 4, 16), 3), _rand((2, 7, 2, 16), 4)
    pos = np.array([3, 9, 10, 11, 20, 40, 63])
    got = trope.apply_rotary_emb(torch.tensor(xq), torch.tensor(xk),
                                 table_t[torch.tensor(pos)])
    want = jrope.apply_rotary_emb(jnp.asarray(xq), jnp.asarray(xk),
                                  table_j[pos])
    _close(got[0], want[0])
    _close(got[1], want[1])


@pytest.mark.parametrize("case", [
    "causal", "right_aligned", "kv_valid_causal", "kv_valid_full", "gqa",
    "full", "bool_mask",
])
def test_sdpa_reference_masks(case):
    B, Sq, Skv, Hq, Hkv, D = 2, 5, 5, 4, 4, 8
    if case in ("right_aligned", "kv_valid_causal", "kv_valid_full"):
        Skv = 9
    if case == "gqa":
        Hkv = 2
    q = _rand((B, Sq, Hq, D), 5)
    k = _rand((B, Skv, Hkv, D), 6)
    v = _rand((B, Skv, Hkv, D), 7)
    mask, valid = None, None
    if case in ("causal", "right_aligned", "gqa", "kv_valid_causal"):
        mask = "causal"
    if case.startswith("kv_valid"):
        valid = np.array([7, 9], np.int32)
    if case == "bool_mask":
        mask = np.random.default_rng(8).uniform(size=(Sq, Skv)) > 0.3
        mask[:, 0] = True
    tmask = torch.tensor(mask) if isinstance(mask, np.ndarray) else mask
    jmask = jnp.asarray(mask) if isinstance(mask, np.ndarray) else mask
    got = tattn.sdpa_reference(
        torch.tensor(q), torch.tensor(k), torch.tensor(v), tmask,
        None if valid is None else torch.tensor(valid))
    want = j_sdpa_reference(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jmask,
        None if valid is None else jnp.asarray(valid))
    _close(got, want)
    _close(tattn.right_aligned_causal_mask(5, 9, device="cpu"),
           j_causal_mask(5, 9))


@pytest.mark.parametrize("size,method", [((28, 28), "bicubic"),
                                         ((64, 64), "bilinear"),
                                         ((4, 4), "bicubic")])
def test_resize_matches_jax_image_resize(size, method):
    x = _rand((2, 56, 56, 3), 9) if size != (4, 4) else _rand((37, 37, 5), 9)
    out_shape = (x.shape[0], *size, 3) if x.ndim == 4 else (*size, 5)
    want = jax.image.resize(jnp.asarray(x), out_shape, method=method)
    got = tresize.resize(torch.tensor(x), size, method)
    _close(got, want, atol=1e-5)


def test_top_p_filter_and_sampling_match():
    """Filtering is the JAX rule exactly; sampling agrees in distribution
    (the frameworks' random bits differ) and exactly when one token is
    kept."""
    rng = np.random.default_rng(10)
    logits = rng.normal(size=(3, 50)).astype(np.float32) * 2
    probs = np.asarray(jax.nn.softmax(jnp.asarray(logits), -1))
    p = 0.8
    psort, idx = tsampling.top_p_filter(torch.tensor(probs), p)
    order = np.argsort(-probs, axis=-1, kind="stable")
    ref_sort = np.take_along_axis(probs, order, -1)
    cum = np.cumsum(ref_sort, -1)
    keep = (cum - ref_sort) <= p
    kept = np.where(keep, ref_sort, 0)
    np.testing.assert_array_equal(idx.numpy(), order)
    _close(psort, kept / kept.sum(-1, keepdims=True), atol=1e-6)

    n = 4000
    u = (np.arange(n) + 0.5) / n
    ours = np.stack([
        tsampling.sample_top_p(torch.tensor(probs), p,
                               uniform=torch.full((3,), float(x))).numpy()
        for x in u[::8]
    ])
    keys = jax.random.split(jax.random.PRNGKey(0), n // 8)
    theirs = np.stack([
        np.asarray(jsampling.sample_top_p(kk, jnp.asarray(probs), p))
        for kk in keys
    ])
    target = kept / kept.sum(-1, keepdims=True)
    for row in range(3):
        allowed = set(order[row][keep[row]].tolist())
        assert set(ours[:, row].tolist()) <= allowed
        assert set(theirs[:, row].tolist()) <= allowed
        for samples in (ours[:, row], theirs[:, row]):
            freq = np.bincount(samples, minlength=50)[order[row]] / len(
                samples)
            assert np.abs(freq - target[row]).max() < 0.08

    peaked = np.zeros((2, 50), np.float32)
    peaked[:, 7] = 0.9
    peaked[:, 8] = 0.1
    got = tsampling.sample_top_p(torch.tensor(peaked), 0.5,
                                 uniform=torch.tensor([0.3, 0.99]))
    want = jsampling.sample_top_p(jax.random.PRNGKey(1), jnp.asarray(peaked),
                                  0.5)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("in_dim,out_dim", [(96, 8), (1088, 8), (13824, 4),
                                            (5120, 16)])
def test_int4_packing_byte_identical(in_dim, out_dim):
    """Same bytes and scales as quant._quantize_leaf_int4, including the
    13B ffn-down padding 13824 -> 14336."""
    w = _rand((in_dim, out_dim), 11, scale=0.05)
    want = jquant._quantize_leaf_int4(w)
    got = tquant._quantize_leaf_int4(torch.tensor(w))
    np.testing.assert_array_equal(got.q.numpy(), np.asarray(want.q))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert (got.group, got.in_dim) == (want.group, want.in_dim)
    assert tquant.int4_geometry(in_dim) == jquant.int4_geometry(in_dim)
    _close(tquant._dequantize_leaf(got, torch.float32),
           jquant._dequantize_leaf(want, jnp.float32))
    lo_t, hi_t = tquant.unpack_int4(got.q)
    lo_j, hi_j = jquant.unpack_int4(want.q)
    np.testing.assert_array_equal(lo_t.numpy(), np.asarray(lo_j))
    np.testing.assert_array_equal(hi_t.numpy(), np.asarray(hi_j))


def _init_tree(cfg, seed):
    """The JAX init's tree of ``cfg`` (its shapes, dtypes and layout, by
    ``eval_shape``) filled from a seeded numpy generator: the JAX
    package's eager init of the tiny towers takes ~40 s on one CPU
    thread."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: jens5.init_ens5_params(k, cfg),
                            jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda x: (0.05 * rng.standard_normal(x.shape)).astype(x.dtype),
        shapes)


def test_quantize_params_matches_blocklist_and_filter():
    cfg = jens5.tiny_ens5_config()
    params = _init_tree(cfg, 0)
    jq = jquant.quantize_params(params["llama"], bits=4)
    tq = tquant.quantize_params(
        params_from_numpy({"llama": params["llama"]},
                          device="cpu")["llama"], bits=4)
    assert isinstance(tq["tok_embeddings"]["weight"], torch.Tensor)
    assert isinstance(tq["output"]["weight"], tquant.QuantizedWeight)
    for i, layer in enumerate(tq["layers"]):
        for sub, names in (("attention", ("wq", "wk", "wv", "wo")),
                           ("feed_forward", ("w1", "w2", "w3"))):
            for n in names:
                got = layer[sub][n]["weight"]
                want = jq["layers"][sub][n]["weight"]
                assert isinstance(got, tquant.QuantizedWeight)
                np.testing.assert_array_equal(got.q.numpy(),
                                              np.asarray(want.q)[i])
        assert isinstance(layer["attention_norm"]["weight"], torch.Tensor)


def _fields(cls):
    return [(f.name, f.default if f.default is not dataclasses.MISSING
             else None) for f in dataclasses.fields(cls)]


@pytest.mark.parametrize("tcls,jcls", [
    (tconfig.ViTConfig, jvit.ViTConfig),
    (tconfig.QFormerConfig, jqformer.QFormerConfig),
    (tconfig.ConvNeXtConfig, jconvnext.ConvNeXtConfig),
])
def test_config_fields_pinned(tcls, jcls):
    assert _fields(tcls) == _fields(jcls)


def test_ens5_configs_pinned():
    for t, j in ((tconfig.CLIP_VIT_L14, jvit.CLIP_VIT_L14),
                 (tconfig.BLIP2_VIT_G14, jvit.BLIP2_VIT_G14),
                 (tconfig.DINOV2_VIT_G14, jvit.DINOV2_VIT_G14),
                 (tconfig.BLIP2_QFORMER, jqformer.BLIP2_QFORMER),
                 (tconfig.CONVNEXT_XXLARGE, jconvnext.CONVNEXT_XXLARGE)):
        assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for t, j in ((tconfig.Ens5Config(), jens5.Ens5Config()),
                 (tconfig.tiny_ens5_config(), jens5.tiny_ens5_config())):
        jd = dataclasses.asdict(j)
        jd.pop("crop_shard_axes")
        assert dataclasses.asdict(t) == jd
        assert (t.image_words, t.ens_dim, t.tokens_per_crop) == (
            j.image_words, j.ens_dim, j.tokens_per_crop)
    assert tconfig.Ens5Config().image_words == 1455


def test_bridge_layouts():
    """Stacked decoder layers unstack, conv kernels turn OIHW, quantized
    leaves keep their bytes, a k_chunks > 1 leaf is repacked to the plain
    split-half layout with the same dense weight."""
    cfg = jens5.tiny_ens5_config()
    jparams = _init_tree(cfg, 1)
    jparams["llama"] = jquant.quantize_params(jparams["llama"], bits=4)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    p = params_from_numpy(tree, device="cpu")
    assert isinstance(p["llama"]["layers"], list)
    assert len(p["llama"]["layers"]) == cfg.llama.n_layers
    wq = p["llama"]["layers"][1]["attention"]["wq"]["weight"]
    jwq = tree["llama"]["layers"]["attention"]["wq"]["weight"]
    np.testing.assert_array_equal(wq.q.numpy(), jwq.q[1])
    np.testing.assert_array_equal(wq.scale.numpy(), jwq.scale[1])
    assert (wq.group, wq.in_dim) == (jwq.group, jwq.in_dim)
    stem = p["convnext"]["stem"]["conv"]["kernel"]
    np.testing.assert_array_equal(
        stem.numpy(),
        np.transpose(tree["convnext"]["stem"]["conv"]["kernel"], (3, 2, 0, 1)))
    assert p["clip"]["patch_embed"]["bias"] is None
    assert p["clip"]["blocks"]["attn"]["wqkv"]["weight"].shape[0] == 2
    assert p["start_img"].dtype == torch.float32
    chunked = jquant._quantize_leaf_int4(_rand((2048, 16), 12), k_chunks=2)
    leaf = params_from_numpy(
        {"w": jax.tree_util.tree_map(np.asarray, chunked)}, device="cpu")["w"]
    assert leaf.q.shape == (1024, 16) and leaf.in_dim == 2048
    np.testing.assert_array_equal(
        tquant._dequantize_leaf(leaf, torch.float32).numpy(),
        np.asarray(jquant._dequantize_leaf(chunked, jnp.float32)))
