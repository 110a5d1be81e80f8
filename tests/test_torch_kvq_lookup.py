"""The single-request latency modes of the PyTorch port against the JAX
package on tiny llama_ens5 in float32: the int8 KV cache, chunked prefill,
prompt-lookup speculative decoding and the in-loop grammar mask. The same
numpy weights go to both packages (``params_from_numpy``), both quantize
the decoder to int4, and both see the same image and prompt.

Tolerances: logits 1e-4 (float32 on both sides, byte-identical int4
weights and, for the int8 cache, byte-identical cache values: only
summation order and transcendental rounding differ); greedy token ids,
speculative statistics and caches written by the same quantizer identical.
Sampled output is compared within the port only (lookup against its own
vanilla loop for one seed): the two packages draw different random
numbers."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.ops import decode_attention as jda
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch.checkpoint.bridge import (
    kv_cache_from_numpy,
    params_from_numpy,
    params_to_numpy,
)
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.lookup_decode import (
    find_draft,
    greedy_reference,
    lookup_generate,
)
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import ens5 as tens5
from a3vlm_tpu_torch.models import llama as tllama
from a3vlm_tpu_torch.ops import decode_attention as tda
from a3vlm_tpu_torch.ops.norms import rms_norm
from a3vlm_tpu_torch.ops.quant_matmul import qmat

torch.set_num_threads(1)
ATOL = 1e-4
PROMPT = ("provide the joint's type and its 2D rotated bounding box "
          "[0.12,0.34,0.56,0.78,0.90] [0.12,0.34,0.56,")


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
    # the port's init, carried to JAX (the JAX package's eager init of the
    # tiny towers takes ~40 s on one CPU thread)
    tree = params_to_numpy(tens5.init_ens5_params(
        tiny_ens5_config(vocab), torch.float32, "cpu",
        torch.Generator().manual_seed(11)))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    image = np.random.default_rng(0).normal(
        size=(1, jcfg.image_size, jcfg.image_size, 3)).astype(np.float32)
    jrec, trec = _Recording(tiny_tokenizer), _Recording(tiny_tokenizer)
    jmodel = JMetaModel(
        "llama_ens5", with_visual=True, max_seq_len=512, dtype=jnp.float32,
        params=jparams, tokenizer=jrec, model_cfg=jcfg,
    )
    jmodel.quantize(bits=4)
    tmodel = MetaModel(
        "llama_ens5", with_visual=True, max_seq_len=512,
        params=params_from_numpy(tree, device="cpu"), tokenizer=trec,
        model_cfg=dataclasses.replace(tiny_ens5_config(vocab)),
    )
    tmodel.quantize(bits=4)
    return {"tok": tiny_tokenizer, "jcfg": jcfg, "tcfg": tmodel.cfg,
            "jmodel": jmodel, "tmodel": tmodel, "jrec": jrec, "trec": trec,
            "image": image}


def _both(setup, prompts, image=True, **kw):
    """(JAX ids, port ids) of one generate call on both models."""
    jimg = setup["image"] if image else None
    timg = torch.tensor(setup["image"]) if image else None
    if image and len(prompts) > 1:
        jimg = np.repeat(jimg, len(prompts), 0)
        timg = timg.repeat(len(prompts), 1, 1, 1)
    setup["jrec"].decoded.clear()
    setup["trec"].decoded.clear()
    setup["jmodel"].generate(prompts, images=jimg, **kw)
    setup["tmodel"].generate(prompts, images=timg, **kw)
    return list(setup["jrec"].decoded), list(setup["trec"].decoded)


def _port_ids(setup, prompts, **kw):
    setup["trec"].decoded.clear()
    setup["tmodel"].generate(prompts, images=torch.tensor(setup["image"]),
                             **kw)
    return list(setup["trec"].decoded)


def _prefill_inputs(setup, n_text=21):
    tokens = np.random.default_rng(1).integers(3, 300, size=(1, n_text))
    tokens[:, 0] = 1
    jmodel, tmodel = setup["jmodel"], setup["tmodel"]
    jimg = jmodel.encode_images(setup["image"])
    with torch.inference_mode():
        timg = tmodel.encode_images(torch.tensor(setup["image"]))
    return tokens, jimg, timg, n_text + setup["jcfg"].image_words


def test_prefill_chunked_matches_one_shot_and_jax(setup):
    """Chunked prefill (chunk 16 over 61 positions, a ragged last piece):
    last-token logits equal the one-shot prefill's and JAX's chunked
    prefill's, and the caches they leave agree."""
    tokens, jimg, timg, S = _prefill_inputs(setup)
    jargs, targs = setup["jcfg"].llama, setup["tcfg"].llama
    jp = setup["jmodel"].params["llama"]
    tp = setup["tmodel"].params["llama"]
    jcache = jllama.KVCache.create(jargs, 1, S + 1, dtype=jnp.float32,
                                   layered=True)
    # jitted: one compile in place of one for every op
    want, jcache, _ = jax.jit(jllama.prefill_chunked, static_argnums=(1, 5))(
        jp, jargs, jcache, jnp.asarray(tokens), jimg, 16)
    with torch.inference_mode():
        c1 = tllama.KVCache.create(targs, 1, S + 1, dtype=torch.float32,
                                   device="cpu")
        one_shot, c1, n1 = tllama.prefill(tp, targs, c1, torch.tensor(tokens),
                                          timg)
        c2 = tllama.KVCache.create(targs, 1, S + 1, dtype=torch.float32,
                                   device="cpu")
        got, c2, n2 = tllama.prefill_chunked(tp, targs, c2,
                                             torch.tensor(tokens), timg, 16)
    assert n1 == n2 == S
    np.testing.assert_allclose(got.numpy(), one_shot.numpy(), atol=ATOL,
                               rtol=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    for layer in range(targs.n_layers):
        np.testing.assert_allclose(c2.k[layer].numpy(), c1.k[layer].numpy(),
                                   atol=ATOL, rtol=0)
        np.testing.assert_allclose(c2.v[layer].numpy(),
                                   np.asarray(jcache.v[layer]), atol=ATOL,
                                   rtol=0)


def test_int8_cache_bridge_and_decode_step(setup):
    """Both packages start from the SAME prefilled int8 cache (JAX's,
    carried over by ``kv_cache_from_numpy``): one decode step gives the
    same logits, and the row it writes is quantized alike."""
    tokens, jimg, timg, S = _prefill_inputs(setup)
    jargs, targs = setup["jcfg"].llama, setup["tcfg"].llama
    jp = setup["jmodel"].params["llama"]
    tp = setup["tmodel"].params["llama"]
    jcache = jllama.KVCache.create(jargs, 1, S + 3, dtype=jnp.int8,
                                   layered=True)
    _, jcache, _ = jllama.prefill(jp, jargs, jcache, jnp.asarray(tokens),
                                  jimg)
    as_numpy = jax.tree_util.tree_map(np.asarray, (jcache.k, jcache.v))
    tcache = kv_cache_from_numpy(*as_numpy, device="cpu")
    assert isinstance(tcache.k[0], tda.QuantizedKV)
    assert tcache.k[0].qv.dtype == torch.int8

    # the port's own int8 prefill writes the same cache, to a rounding step
    with torch.inference_mode():
        own = tllama.KVCache.create(targs, 1, S + 3, dtype=torch.int8,
                                    device="cpu")
        tllama.prefill(tp, targs, own, torch.tensor(tokens), timg)
    diff = (own.k[1].qv.int() - tcache.k[1].qv.int()).abs()
    assert int(diff.max()) <= 1 and float((diff != 0).float().mean()) < 0.01

    nxt = np.array([[7]])
    want, jcache = jllama.decode_step(jp, jargs, jcache, jnp.asarray(nxt), S)
    with torch.inference_mode():
        got, tcache = tllama.decode_step(tp, targs, tcache, torch.tensor(nxt),
                                         S)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    # the row the step wrote: each package quantized its own k (equal to
    # float32 rounding), so scales agree closely and values to one step
    np.testing.assert_allclose(tcache.k[0].scale[:, :, S].numpy(),
                               np.asarray(jcache.k[0].scale[:, :, S]),
                               rtol=1e-5)
    step = np.abs(tcache.k[0].qv[:, :, S].numpy().astype(np.int32)
                  - np.asarray(jcache.k[0].qv[:, :, S], np.int32))
    assert step.max() <= 1


def test_per_row_positions_match_jax_ragged_step(setup):
    """``forward_hidden`` with positions [B, 1] and a per-row ``write_pos``
    [B] (rows of one batch at different absolute positions) against the
    JAX ``decode_step_ragged``, dense and int8 caches."""
    jargs, targs = setup["jcfg"].llama, setup["tcfg"].llama
    jp = setup["jmodel"].params["llama"]
    tp = setup["tmodel"].params["llama"]
    rng = np.random.default_rng(5)
    B, S = 2, 24
    pos = np.array([9, 17], np.int32)
    tok = rng.integers(3, 300, size=(B, 1))
    for dtype_j, dtype_t in ((jnp.float32, torch.float32),
                             (jnp.int8, torch.int8)):
        jcache = jllama.KVCache.create(jargs, B, S, dtype=dtype_j,
                                       layered=True)
        tcache = tllama.KVCache.create(targs, B, S, dtype=dtype_t,
                                       device="cpu")
        # a shared random history: write 17 rows through both packages
        hist = rng.normal(size=(B, 17, targs.kv_heads, targs.head_dim)
                          ).astype(np.float32)
        jk, jv = [], []
        for layer in range(targs.n_layers):
            k2, v2 = jda.update_decode_cache(
                jcache.k[layer], jcache.v[layer], jnp.asarray(hist),
                jnp.asarray(hist[..., ::-1].copy()), 0, layout="bhsd")
            jk.append(k2)
            jv.append(v2)
            tda.update_decode_cache(tcache.k[layer], tcache.v[layer],
                                    torch.tensor(hist),
                                    torch.tensor(hist[..., ::-1].copy()), 0)
        jcache = jllama.KVCache(tuple(jk), tuple(jv))
        want, _ = jllama.decode_step_ragged(jp, jargs, jcache,
                                            jnp.asarray(tok),
                                            jnp.asarray(pos))
        with torch.inference_mode():
            tpos = torch.tensor(pos)
            h = tllama.embed_tokens(tp, torch.tensor(tok))
            h, _ = tllama.forward_hidden(
                tp, targs, h, tpos.long()[:, None], None, cache=tcache,
                write_pos=tpos, kv_valid_len=tpos + 1)
            h = rms_norm(h, tp["norm"]["weight"], targs.norm_eps)
            got = qmat(h[:, -1, :], tp["output"]["weight"]).float()
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                                   rtol=0)


def test_kv_cache_bits_8_greedy_ids_equal_jax(setup):
    """Greedy generation over the int8 cache, two prompts of different
    lengths: the port's ids equal the JAX ``Generator(kv_cache_bits=8)``
    ids. Setting the property drops the cached generator."""
    jmodel, tmodel = setup["jmodel"], setup["tmodel"]
    prompts = [PROMPT, "### Human: please provide the joint's type"]
    tmodel.generate(prompts[:1], images=torch.tensor(setup["image"]),
                    max_gen_len=2)
    assert tmodel._generator is not None
    jmodel.kv_cache_bits = tmodel.kv_cache_bits = 8
    assert tmodel._generator is None and tmodel.kv_cache_bits == 8
    try:
        want, got = _both(setup, prompts, max_gen_len=12)
        assert tmodel._generator.kv_cache_bits == 8
    finally:
        jmodel.kv_cache_bits = tmodel.kv_cache_bits = None
    assert got == want
    assert max(len(ids) for ids in got) >= 8
    with pytest.raises(ValueError):
        tmodel.kv_cache_bits = 4


@pytest.mark.parametrize("draft_k,kv_bits", [(4, None), (8, None), (8, 8)])
def test_draft_k_equals_vanilla_and_jax(setup, draft_k, kv_bits):
    """Prompt-lookup speculation at batch 1: ids equal the port's vanilla
    greedy ids and JAX's lookup ids, and the realized acceptance
    (``last_spec_stats``) equals JAX's; also over the int8 cache, and with
    a multi-token stop symbol matched on the host."""
    jmodel, tmodel = setup["jmodel"], setup["tmodel"]
    jmodel.kv_cache_bits = tmodel.kv_cache_bits = kv_bits
    try:
        for stops in ((), ("0.",)):
            kw = {"max_gen_len": 20, "additional_stop_symbols": stops}
            vanilla = _port_ids(setup, [PROMPT], **kw)
            want, got = _both(setup, [PROMPT], draft_k=draft_k, **kw)
            assert got == vanilla, (stops, got, vanilla)
            assert got == want, (stops, got, want)
            assert (tmodel.last_spec_stats
                    == jmodel._generator.last_spec_stats)
        assert tmodel.last_spec_stats["verify_rounds"] >= 1
    finally:
        jmodel.kv_cache_bits = tmodel.kv_cache_bits = None


def test_draft_k_batch_of_two_takes_vanilla_loop(setup):
    prompts = [PROMPT, "### Human: please provide the joint's type"]
    timg = torch.tensor(setup["image"]).repeat(2, 1, 1, 1)
    tmodel = setup["tmodel"]
    want = tmodel.generate(prompts, images=timg, max_gen_len=8)
    before = tmodel.last_spec_stats
    got = tmodel.generate(prompts, images=timg, max_gen_len=8, draft_k=6)
    assert got == want and tmodel.last_spec_stats == before


def test_generate_sets_fresh_last_stats(setup):
    """The text entry reports its own call, towers included, as
    ``generate_tokens`` does: ``last_stats`` is replaced, not left from the
    previous call."""
    tmodel = setup["tmodel"]
    tmodel.last_stats = {"stale": True}
    tmodel.generate([PROMPT], images=torch.tensor(setup["image"]),
                    max_gen_len=3)
    stats = tmodel.last_stats
    assert set(stats) == {"towers_ms", "prefill_ms", "decode_ms",
                          "decode_steps", "decode_issue_ms", "decode_wait_ms",
                          "row_steps_forced", "row_steps_asked",
                          "row_steps_spare"}
    assert stats["towers_ms"] > 0 and stats["decode_steps"] >= 1
    tmodel.generate([PROMPT], max_gen_len=2)
    assert tmodel.last_stats is not stats
    assert set(tmodel.last_stats) == set(stats)


@pytest.mark.parametrize("draft_k", [0, 6])
def test_grammar_constrained_ids_equal_jax(setup, draft_k):
    """The in-loop grammar mask (first token masked at DFA state 0, one
    state per row): constrained greedy ids equal JAX's, vanilla and
    through lookup; the text parses under the grammar; the port's own
    copy of ``constrained`` compiled the table it used."""
    tok = setup["tok"]
    jfsm = jconstrained.compile_grammar(jconstrained.joint_rec_grammar(), tok)
    tfsm = tconstrained.compile_grammar(tconstrained.joint_rec_grammar(), tok)
    np.testing.assert_array_equal(tfsm.next_state, jfsm.next_state)
    prompts = ["provide the joint's type and its 2D rotated bounding box"]
    kw = {"max_gen_len": 40, "draft_k": draft_k}
    setup["jrec"].decoded.clear()
    setup["trec"].decoded.clear()
    want = setup["jmodel"].generate(prompts, images=setup["image"], fsm=jfsm,
                                    **kw)
    got = setup["tmodel"].generate(prompts,
                                   images=torch.tensor(setup["image"]),
                                   fsm=tfsm, **kw)
    assert setup["trec"].decoded == setup["jrec"].decoded
    assert got == want
    dfa = tconstrained.CharDfa(tconstrained.Seq(
        tconstrained.Opt(tconstrained.Lit(" ")),
        tconstrained.joint_rec_grammar()))
    state = 0
    for t in setup["trec"].decoded[0]:
        assert tfsm.next_state[state, t] >= 0
        state = int(tfsm.next_state[state, t])
    if len(setup["trec"].decoded[0]) < 40:  # stopped: the answer is whole
        assert dfa.matches(got[0]), repr(got[0])


@pytest.mark.parametrize("use_fsm", [False, True])
def test_sampled_lookup_equals_port_vanilla(setup, use_fsm):
    """temperature > 0 with draft_k: emitted index t uses the same uniform
    in both loops, so for one seed the ids are the vanilla loop's."""
    tok = setup["tok"]
    fsm = (tconstrained.compile_grammar(tconstrained.joint_rec_grammar(), tok)
           if use_fsm else None)
    kw = {"max_gen_len": 16, "temperature": 0.8, "top_p": 0.9, "fsm": fsm}
    for seed in (0, 3):
        want = _port_ids(setup, [PROMPT], seed=seed, **kw)
        got = _port_ids(setup, [PROMPT], seed=seed, draft_k=5, **kw)
        assert got == want, (seed, got, want)
    other = _port_ids(setup, [PROMPT], seed=4, **kw)
    assert other != want  # the seed matters


def _llama_setup(setup, prompt, total):
    targs = setup["tcfg"].llama
    tp = setup["tmodel"].params["llama"]
    with torch.inference_mode():
        cache = tllama.KVCache.create(targs, 1, total, dtype=torch.float32,
                                      device="cpu")
        logits, cache, _ = tllama.prefill(tp, targs, cache,
                                          torch.tensor([prompt]))
    return tp, targs, cache, int(torch.argmax(logits[0, :250]))


@pytest.mark.parametrize("caps", [None, (0,), (1, 0)])
def test_lookup_generate_exact_and_accept_cap(setup, caps):
    """``lookup_generate`` on a repetitive prompt equals
    ``greedy_reference``; ``accept_cap`` keeps the output and can only add
    rounds; the count, the rounds and the cache sizing hold."""
    rng = np.random.default_rng(2)
    pat = rng.integers(5, 30, size=6).tolist()
    prompt = [1] + pat * 6 + pat[:3]
    gen, K = 24, 6
    total = len(prompt) + gen + K + 1
    tp, targs, cache, first = _llama_setup(setup, prompt, total)
    expected = greedy_reference(tp, targs, cache, len(prompt), first, gen,
                                vocab_limit=250, stop_token=2)
    tp, targs, cache, _ = _llama_setup(setup, prompt, total)
    out, count, rounds = lookup_generate(
        tp, targs, cache, prompt, len(prompt), first, gen_len=gen, draft_k=K,
        vocab_limit=250, stop_token=2, accept_cap=caps)
    assert out[:count].tolist() == expected
    tp, targs, cache, _ = _llama_setup(setup, prompt, total)
    _, _, free_rounds = lookup_generate(
        tp, targs, cache, prompt, len(prompt), first, gen_len=gen, draft_k=K,
        vocab_limit=250, stop_token=2)
    assert rounds >= free_rounds and 1 <= rounds <= count
    if caps == (0,):
        assert rounds == count - 1  # one token per round


def test_lookup_stops_at_first_token_and_find_draft():
    buf = np.array([1, 7, 8, 9, 5, 7, 8, 0, 0, 0, 0, 0], np.int64)
    # suffix (7, 8) matched at index 1: the draft is what followed it
    np.testing.assert_array_equal(find_draft(buf, 7, 4), [9, 5, 7])
    # no earlier occurrence of the last token: repeat it
    np.testing.assert_array_equal(
        find_draft(np.array([1, 2, 3, 0, 0, 0], np.int64), 3, 3), [3, 3])


def test_fused_and_two_step_paths_agree_on_bf16():
    """The dispatcher on bf16 CPU tensors (the wrappers' plain versions):
    ``FUSE_UPDATE_ATTEND`` off takes write-then-attend and leaves the same
    caches; dense and int8 caches; a chunked-prefill piece through
    ``valid_static`` equals the plain right-aligned causal attention."""
    rng = np.random.default_rng(9)
    B, Hkv, G, S, D = 2, 2, 2, 24, 128

    def t(*shape):
        return torch.tensor(rng.normal(size=shape).astype(np.float32)).to(
            torch.bfloat16)

    xq, xk, xv = t(B, 1, Hkv * G, D), t(B, 1, Hkv, D), t(B, 1, Hkv, D)
    hist = t(B, 16, Hkv, D)
    valid = torch.tensor([17, 17], dtype=torch.int32)
    for quant in (False, True):
        outs, caches = [], []
        for fuse in (True, False):
            if quant:
                ck, cv = (tda.make_quantized_kv(B, Hkv, S, D, device="cpu")
                          for _ in range(2))
            else:
                ck, cv = (torch.zeros(B, Hkv, S, D, dtype=torch.bfloat16)
                          for _ in range(2))
            tda.update_decode_cache(ck, cv, hist, hist, 0)
            tda.FUSE_UPDATE_ATTEND = fuse
            try:
                outs.append(tda.update_and_attend_decode_cache(
                    xq, ck, cv, xk, xv, 16, valid, mask=None))
            finally:
                tda.FUSE_UPDATE_ATTEND = True
            caches.append((ck, cv))
        np.testing.assert_allclose(outs[0].float().numpy(),
                                   outs[1].float().numpy(), atol=2.0 ** -6)
        for a, b in zip(caches[0], caches[1]):
            for x, y in zip(a if quant else (a,), b if quant else (b,)):
                assert torch.equal(x, y)

    # a 4-token piece ending at row 20 of a dense cache
    ck, cv = t(B, Hkv, S, D), t(B, Hkv, S, D)
    piece = t(B, 4, Hkv * G, D)
    v20 = torch.tensor([20, 20], dtype=torch.int32)
    flash = tda.attend_decode_cache(piece, ck, cv, mask="causal",
                                    kv_valid_len=v20, valid_static=20)
    plain = tda.attend_decode_cache(piece, ck, cv, mask="causal",
                                    kv_valid_len=v20, impl="plain")
    np.testing.assert_allclose(flash.float().numpy(), plain.float().numpy(),
                               atol=2.0 ** -6)
