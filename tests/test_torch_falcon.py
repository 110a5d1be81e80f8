"""``llama_type="falcon"`` in the PyTorch port against the JAX package on
tiny configs in float32: a grouped-query config (4 query heads over 2 kv
heads) and a multi-query one (one kv head). The same numpy weights go to
both packages (``params_from_numpy``, and back through
``params_to_numpy``), and both see the same token ids.

Tolerances: logits (training forward, prefill and decode over a float32,
a bf16 and an int8 cache), the loss and every gradient 1e-4 (float32 on
both sides; only summation order and transcendental rounding differ); the
half-split rotary 1e-6; greedy token ids and strings identical through
``generate`` (dense, int4, the int8 cache) and ``stream_generate``. Where
the JAX package fails (``from_pretrained`` of a falcon checkpoint, hence
the eval CLI), the port raises ``ValueError`` before reading it."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import _Recording, numpy_tree

from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import falcon as jfalcon
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.train.losses import next_token_loss as jloss
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from a3vlm_tpu_torch.generation import FALCON_GEN_OPS
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import falcon as tfalcon
from a3vlm_tpu_torch.quant import tree_map

torch.set_num_threads(1)
ATOL = 1e-4
PROMPTS = ["### Human: please provide the joint's type",
           "detect all manipulable object parts"]
CONFIGS = {
    "gqa": dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                num_kv_heads=2),
    "mq": dict(num_layers=2, hidden_size=64, num_attention_heads=4,
               multi_query=True, rope_theta=1e6),
}


def _pair(tok, config: str, quant: bool) -> dict:
    vocab = -(-tok.n_words // 128) * 128
    fields = CONFIGS[config]
    jargs = jfalcon.FalconArgs(vocab_size=vocab, max_seq_len=128, **fields)
    tree = numpy_tree(jfalcon.init_falcon_params, jargs, 31)
    jrec, trec = _Recording(tok), _Recording(tok)
    jm = JMetaModel("falcon", max_seq_len=128, dtype=jnp.float32,
                    params=jax.tree_util.tree_map(jnp.asarray, tree),
                    tokenizer=jrec, model_cfg=jargs)
    tm = MetaModel("falcon", max_seq_len=128,
                   params=params_from_numpy(tree, device="cpu"),
                   tokenizer=trec, model_cfg=tfalcon.FalconArgs(**fields),
                   device="cpu")
    if quant:
        jm.quantize(bits=4)
        tm.quantize(bits=4)
    return {"jm": jm, "tm": tm, "jrec": jrec, "trec": trec, "tree": tree}


@pytest.fixture(scope="module", params=list(CONFIGS))
def config(request):
    return request.param


@pytest.fixture(scope="module")
def dense(config, tiny_tokenizer):
    return _pair(tiny_tokenizer, config, quant=False)


@pytest.fixture(scope="module")
def int4(config, tiny_tokenizer):
    return _pair(tiny_tokenizer, config, quant=True)


def test_config_and_tree_equal_jax(dense):
    """The constructor's args (the vocab padded, max_seq_len replaced), the
    defaults of ``FalconArgs`` and the tree through the bridge both
    ways."""
    jm, tm = dense["jm"], dense["tm"]
    assert dataclasses.asdict(tm.args) == dataclasses.asdict(jm.args)
    assert (tm.args.head_dim, tm.args.kv_heads) == (jm.args.head_dim,
                                                   jm.args.kv_heads)
    assert dataclasses.asdict(tfalcon.FalconArgs()) == dataclasses.asdict(
        jfalcon.FalconArgs())
    assert tm.image_words == jm.image_words == 0
    assert tm.get_quant_blocklist() == jm.get_quant_blocklist() == []
    assert all(jax.tree_util.tree_leaves(jm.get_trainable_params()))
    back = params_to_numpy(tm.params)
    flat_want = jax.tree_util.tree_leaves_with_path(dense["tree"])
    flat_got = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_got) == len(flat_want)
    for path, want in flat_want:
        np.testing.assert_array_equal(flat_got[path], want)


def test_rotary_half_split_matches_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 5, 3, 16)).astype(np.float32)
    table = np.asarray(jfalcon._freqs(jfalcon.FalconArgs(
        hidden_size=64, num_attention_heads=4, max_seq_len=8),
        jnp.arange(5)))
    want = np.asarray(jfalcon.apply_rotary_half_split(jnp.asarray(x),
                                                      jnp.asarray(table)))
    got = tfalcon.apply_rotary_half_split(torch.tensor(x),
                                          torch.tensor(table))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-6, rtol=0)
    # half-split, not interleaved: x[i] pairs with x[i + 8]
    lo = x[..., :8] * table[None, :, None, :, 0] \
        - x[..., 8:] * table[None, :, None, :, 1]
    np.testing.assert_allclose(got.numpy()[..., :8], lo, atol=1e-6)


def _batch():
    rng = np.random.default_rng(3)
    examples = rng.integers(3, 300, size=(2, 12))
    examples[:, 0] = 1
    labels = examples.copy()
    labels[:, :4] = 0
    return examples, labels


def test_forward_train_logits_match(dense):
    jm, tm = dense["jm"], dense["tm"]
    examples, _ = _batch()
    # jitted: one compile in place of one for every op
    want = jax.jit(jfalcon.forward_train, static_argnums=1)(
        jm.params, jm.args, jnp.asarray(examples))
    with torch.inference_mode():
        got = tfalcon.forward_train(tm.params, tm.args,
                                    torch.tensor(examples))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)


def test_loss_and_gradients_match(dense):
    """``MetaModel.forward``'s loss, and the gradient of every leaf of the
    tree (the JAX one of the same loss over the same weights)."""
    jm, tm = dense["jm"], dense["tm"]
    examples, labels = _batch()
    want = float(jm.forward(jnp.asarray(examples), jnp.asarray(labels)))

    def jax_loss(p):
        logits = jfalcon.forward_train(p, jm.args, jnp.asarray(examples))
        return jloss(logits, jnp.asarray(labels), vocab_size=jm.true_vocab)

    jgrads = jax.jit(jax.grad(jax_loss))(jm.params)
    params = params_from_numpy(dense["tree"], device="cpu")
    tree_map(lambda t: t.requires_grad_(True), params)
    tm_grad = MetaModel("falcon", max_seq_len=128, params=params,
                        tokenizer=tm.tokenizer, model_cfg=tm.args,
                        device="cpu")
    loss = tm_grad.forward(torch.tensor(examples), torch.tensor(labels))
    assert abs(float(loss.detach()) - want) <= ATOL
    loss.backward()
    got = params_to_numpy(tree_map(lambda t: t.grad, params))
    flat = dict(jax.tree_util.tree_leaves_with_path(got))
    for path, g in jax.tree_util.tree_leaves_with_path(jgrads):
        np.testing.assert_allclose(flat[path], np.asarray(g), atol=ATOL,
                                   rtol=0, err_msg=str(path))
    assert max(float(np.abs(np.asarray(g)).max())
               for g in jax.tree_util.tree_leaves(jgrads)) > 1e-3


_CACHES = {"f32": (jnp.float32, torch.float32),
           "bf16": (jnp.bfloat16, torch.bfloat16),
           "int8": (jnp.int8, torch.int8)}


@pytest.mark.parametrize("cache", list(_CACHES))
def test_prefill_and_decode_logits_match(dense, cache):
    """Prefill of 9 ids, then two decode steps, over each cache kind."""
    jm, tm = dense["jm"], dense["tm"]
    jdt, tdt = _CACHES[cache]
    tokens = np.random.default_rng(1).integers(3, 300, size=(2, 9))
    tokens[:, 0] = 1
    jp = jllama.unstack_layers(jm.params)
    jcache = jfalcon.FalconKVCache.create(jm.args, 2, max_seq_len=12,
                                          dtype=jdt, layered=True)
    tcache = tfalcon.FalconKVCache.create(tm.args, 2, max_seq_len=12,
                                          dtype=tdt, device="cpu")
    want, jcache, _ = jfalcon.prefill(jp, jm.args, jcache,
                                      jnp.asarray(tokens))
    with torch.inference_mode():
        got, tcache, n = tfalcon.prefill(tm.params, tm.args, tcache,
                                         torch.tensor(tokens))
    assert n == 9
    pairs = [(np.asarray(want), got.numpy())]
    for step, nxt in enumerate(([[5], [6]], [[7], [8]])):
        want, jcache = jfalcon.decode_step(jp, jm.args, jcache,
                                           jnp.asarray(nxt), 9 + step)
        with torch.inference_mode():
            got, tcache = tfalcon.decode_step(tm.params, tm.args, tcache,
                                              torch.tensor(nxt), 9 + step)
        pairs.append((np.asarray(want), got.numpy()))
    for want, got in pairs:
        assert got.shape == want.shape == (2, tm.args.vocab_size)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_int4_prefill_logits_match(int4):
    """``quantize(4)``: the same packed weights (the embeddings and norms
    dense), the same logits."""
    jm, tm = int4["jm"], int4["tm"]
    assert type(tm.params["layers"][0]["mlp"]["dense_h_to_4h"]["weight"]
                ).__name__ == "QuantizedWeight"
    tokens = np.random.default_rng(2).integers(3, 300, size=(2, 7))
    texts = [list(t) for t in tokens]
    for a, b in zip(tm.compute_logits(texts), jm.compute_logits(texts)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_compute_logits_and_scoring_match(dense):
    """The scoring APIs; images are ignored by both packages' falcon."""
    jm, tm = dense["jm"], dense["tm"]
    texts = ["hello door", "the answer is <rb>revolute</rb>"]
    images = np.zeros((2, 8, 8, 3), np.float32)
    for a, b in zip(tm.compute_logits(texts, images=images),
                    jm.compute_logits(texts, images=images)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    got = tm.evaluate_examples(texts, contexts=["hello", "the answer"])
    want = jm.evaluate_examples(texts, contexts=["hello", "the answer"])
    np.testing.assert_allclose(got["log_likelihood"], want["log_likelihood"],
                               atol=1e-3, rtol=0)
    assert got["max_equal"] == want["max_equal"]


def _ids(s, prompts, **kw):
    s["jrec"].decoded.clear()
    s["trec"].decoded.clear()
    want = s["jm"].generate(prompts, **kw)
    got = s["tm"].generate(prompts, **kw)
    return list(s["jrec"].decoded), list(s["trec"].decoded), want, got


@pytest.mark.parametrize("mode", ["vanilla", "kv8", "chunk", "draft_k"])
def test_generate_greedy_identical(dense, int4, mode):
    """Greedy ``generate``, dense and int4, ids and strings identical; with
    the int8 cache; ``prefill_chunk`` and ``draft_k`` take the one-piece
    prefill and the vanilla loop in both packages (falcon's ops have
    neither)."""
    kw = dict(max_gen_len=10)
    prompts = PROMPTS[:1] if mode == "draft_k" else PROMPTS
    if mode == "draft_k":
        kw["draft_k"] = 6
    for s in (dense, int4):
        try:
            for m in (s["jm"], s["tm"]):
                m.kv_cache_bits = 8 if mode == "kv8" else None
                m.prefill_chunk = 4 if mode == "chunk" else None
            want_ids, got_ids, want, got = _ids(s, prompts, **kw)
        finally:
            for m in (s["jm"], s["tm"]):
                m.kv_cache_bits = None
                m.prefill_chunk = None
        assert got_ids == want_ids
        assert got == want
        assert max(len(ids) for ids in got_ids) >= 4
    assert dense["tm"]._get_generator().ops is FALCON_GEN_OPS


def test_stream_generate_matches_jax(dense, int4):
    for s in (dense, int4):
        chunks = list(s["tm"].stream_generate("hello door", max_gen_len=8))
        jchunks = list(s["jm"].stream_generate("hello door", max_gen_len=8))
        assert chunks[-1]["end_of_content"]
        assert [c["text"] for c in chunks] == [c["text"] for c in jchunks]
        assert chunks[-1]["text"] == s["tm"].generate(["hello door"],
                                                      max_gen_len=8)[0]


def test_images_refused_as_jax(dense):
    """Falcon is text-only: ``generate`` with images fails in both
    packages (the JAX family module has no image tokens)."""
    with pytest.raises(AttributeError):
        dense["jm"].generate(PROMPTS[:1], images=np.zeros((1, 8, 8, 3)),
                             max_gen_len=2)
    with pytest.raises(ValueError, match="falcon takes no images"):
        dense["tm"].generate(PROMPTS[:1], images=torch.zeros(1, 8, 8, 3),
                             max_gen_len=2)


def test_from_pretrained_and_eval_cli_fail_as_jax(tiny_tokenizer_dir,
                                                  tmp_path):
    """A falcon checkpoint dir (``meta.json``, a tiny ``config.json``, the
    tokenizer, one consolidated file): the JAX ``from_pretrained`` builds
    the model, reads the file and fails importing it with LLaMA's importer
    (``n_layers``); the port's refuses with ``ValueError`` before reading,
    and so does its eval CLI."""
    (tmp_path / "meta.json").write_text(json.dumps({"llama_type": "falcon"}))
    (tmp_path / "config.json").write_text(json.dumps(CONFIGS["gqa"]))
    torch.save({"model": {"transformer.word_embeddings.weight":
                          torch.zeros(4, 64)}},
               tmp_path / "consolidated.00-of-01.model.pth")
    with pytest.raises(AttributeError, match="n_layers"):
        JMetaModel.from_pretrained(str(tmp_path),
                                   tokenizer_path=tiny_tokenizer_dir,
                                   dtype=jnp.float32)
    with pytest.raises(ValueError, match="falcon"):
        MetaModel.from_pretrained(str(tmp_path),
                                  tokenizer_path=tiny_tokenizer_dir,
                                  device="cpu")
    tasks = tmp_path / "tasks.json"
    tasks.write_text("[]")
    with pytest.raises(ValueError, match="falcon"):
        teval.main(["--pretrained_path", str(tmp_path), "--llama_type",
                    "falcon", "--dataset",
                    str(tasks), "--tokenizer_path", tiny_tokenizer_dir,
                    "--output_dir", str(tmp_path / "out"), "--device",
                    "cpu"])


def test_decode_gates_take_head_dim_64():
    """The decode kernel has instances at head dims 128 and 64 (falcon):
    the fused gate takes both and no other; the verify kernel stays at
    128; a stage holds 8 KB of each panel."""
    from a3vlm_tpu_torch.ops import decode_attention as dec

    valid = torch.ones(1, dtype=torch.int32)
    for D, want in ((64, True), (128, True), (96, False), (32, False)):
        xq = torch.zeros(1, 1, 4, D, dtype=torch.bfloat16)
        cache = torch.zeros(1, 2, 8, D, dtype=torch.bfloat16)
        assert dec.fused_eligible(xq, cache, None, valid) == want, D
    assert dec.DECODE_HEAD_DIMS == (64, 128)
    assert [dec.decode_stage_rows(q, D) for q in (False, True)
            for D in (128, 64)] == [32, 64, 64, 128]
    assert not dec.verify_attention_eligible(
        torch.zeros(1, 4, 4, 64, dtype=torch.bfloat16))
