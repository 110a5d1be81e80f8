"""The tiny llama_ens5 slice of the PyTorch port in each quantized-matmul
mode against the JAX ``MetaModel`` in the same mode, on the CPU (split from
``test_torch_quant_modes.py``, which holds the kernels' plain versions, the
quantizers and the dispatcher, so that the two halves run on two workers).

Tolerances: image tokens and prefill logits 1e-4 as in
``test_torch_slice.py`` (float32, byte-identical quantized weights, and in
the A8 modes byte-identical int8 activations wherever the float32 inputs
agree to the last bit of a rounding tie); greedy ids identical.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

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


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, dtype=np.float32)).to(dtype)


@pytest.fixture
def one_device(monkeypatch):
    """The JAX dispatchers read their mode flags on the single-device path
    only; the tests run on a forced 8-device CPU mesh, so pin the count the
    dispatchers see, as the JAX package's own tests do."""
    real = jax.devices
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])


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
    tcfg = tiny_ens5_config(vocab)
    # the port's init, carried to JAX (the JAX package's eager init of the
    # tiny towers takes ~40 s on one CPU thread)
    tree = params_to_numpy(tens5.init_ens5_params(
        tcfg, torch.float32, "cpu", torch.Generator().manual_seed(11)))
    return {
        "tok": tiny_tokenizer, "jcfg": jcfg, "tcfg": tcfg,
        "jparams": jax.tree_util.tree_map(jnp.asarray, tree), "tree": tree,
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
    # the JAX side's tower quantizer and decode step jitted: one compile
    # each in place of one for every op (the prefill stays eager: jitted,
    # XLA's fusions move the A8 modes' rounding ties)
    monkeypatch.setattr(jens5, "quantize_tower_params",
                        jax.jit(jens5.quantize_tower_params))
    j_decode = jax.jit(jllama.decode_step, static_argnums=1)
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
        want_d, _ = j_decode(jp, jcfg.llama, jcache, jnp.asarray(nxt), S)
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
