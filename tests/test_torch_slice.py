"""The llama_ens5 image->text slice of the PyTorch port against the JAX
package end to end, on the tiny config in float32: the same numpy weights
go to both (through ``params_from_numpy``), both quantize the decoder to
int4, and both see the same images and prompts.

Tolerances: image tokens and prefill logits 1e-4 (float32 on both sides;
the int4 weights are byte-identical, so only summation order and
transcendental rounding differ); greedy token ids and decoded strings
identical."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.quant import quantize_params as j_quantize_params
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import ens5 as tens5
from a3vlm_tpu_torch.models import llama as tllama

torch.set_num_threads(1)
ATOL = 1e-4


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
    jparams = jens5.init_ens5_params(jax.random.PRNGKey(7), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    rng = np.random.default_rng(0)
    images = rng.normal(size=(2, jcfg.image_size, jcfg.image_size, 3)).astype(
        np.float32)
    return {
        "tok": tiny_tokenizer, "jcfg": jcfg, "tcfg": tiny_ens5_config(vocab),
        "jparams": jparams, "tree": tree, "images": images,
    }


def test_image_tokens_match(setup):
    want = jens5.build_image_tokens(setup["jparams"], setup["jcfg"],
                                    jnp.asarray(setup["images"]))
    tparams = params_from_numpy(setup["tree"], device="cpu")
    got = tens5.build_image_tokens(tparams, setup["tcfg"],
                                   torch.tensor(setup["images"]))
    assert got.shape == (2, setup["tcfg"].image_words, 64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_int4_prefill_logits_match(setup):
    jcfg, tcfg = setup["jcfg"], setup["tcfg"]
    jp = dict(setup["jparams"])
    jp["llama"] = jllama.unstack_layers(j_quantize_params(jp["llama"], bits=4))
    tp = params_from_numpy(setup["tree"], device="cpu")
    from a3vlm_tpu_torch.quant import quantize_params

    quantize_params(tp["llama"], bits=4)
    tokens = np.random.default_rng(1).integers(3, 300, size=(2, 9))
    tokens[:, 0] = 1
    images = setup["images"]
    S = 9 + jcfg.image_words
    jcache = jllama.KVCache.create(jcfg.llama, 2, max_seq_len=S + 1,
                                   dtype=jnp.float32, layered=True)
    want, jcache, _ = jens5.prefill(jp, jcfg, jcache, jnp.asarray(tokens),
                                    image=jnp.asarray(images))
    tcache = tllama.KVCache.create(tcfg.llama, 2, max_seq_len=S + 1,
                                   dtype=torch.float32, device="cpu")
    got, tcache, n = tens5.prefill(tp, tcfg, tcache, torch.tensor(tokens),
                                   image=torch.tensor(images))
    assert n == S and got.shape == (2, tcfg.llama.vocab_size)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for layer in range(tcfg.llama.n_layers):
        np.testing.assert_allclose(tcache.k[layer].numpy(),
                                   np.asarray(jcache.k[layer]), atol=ATOL,
                                   rtol=0)
    # one decode step over the written cache
    nxt = np.array([[5], [6]])
    want_d, _ = jens5.decode_step(jp, jcfg, jcache, jnp.asarray(nxt), S)
    got_d, _ = tens5.decode_step(tp, tcfg, tcache, torch.tensor(nxt), S)
    np.testing.assert_allclose(got_d.numpy(), np.asarray(want_d), atol=ATOL,
                               rtol=0)


def test_metamodel_generate_greedy_identical(setup):
    """Greedy MetaModel.generate in both packages: same token ids for
    prompts of different lengths (prompt forcing after the bucketed
    prefill), same strings, and the token-id entry agrees."""
    tok = setup["tok"]
    jrec, trec = _Recording(tok), _Recording(tok)
    jmodel = JMetaModel(
        "llama_ens5", with_visual=True, max_seq_len=512, dtype=jnp.float32,
        params=setup["jparams"], tokenizer=jrec, model_cfg=setup["jcfg"],
    )
    jmodel.quantize(bits=4)
    tmodel = MetaModel(
        "llama_ens5", with_visual=True, max_seq_len=512,
        params=params_from_numpy(setup["tree"], device="cpu"), tokenizer=trec,
        model_cfg=dataclasses.replace(setup["tcfg"]),
    )
    tmodel.quantize(bits=4)
    prompts = ["### Human: please provide the joint's type",
               "detect all manipulable object parts and provide their "
               "rotated bounding boxes"]
    want = jmodel.generate(prompts, images=setup["images"], max_gen_len=10)
    got = tmodel.generate(prompts, images=torch.tensor(setup["images"]),
                          max_gen_len=10)
    assert trec.decoded == jrec.decoded
    assert got == want
    assert max(len(ids) for ids in trec.decoded) >= 8

    ids = tmodel.generate_tokens(
        [tok.encode(p, bos=True, eos=False) for p in prompts],
        images=torch.tensor(setup["images"]), max_gen_len=10,
        stop_tokens=[(tok.eos_id,)],
    )
    assert ids == trec.decoded
    assert set(tmodel.last_stats) == {"towers_ms", "prefill_ms", "decode_ms",
                                      "decode_steps"}
