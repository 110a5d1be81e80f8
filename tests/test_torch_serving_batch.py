"""Continuous batching in the PyTorch port against the JAX package, on the
CPU at a tiny size (2 layers, dim 64, float32): the ragged decode and verify
steps, and ``ContinuousBatcher`` (admission, prefix caching, the three
decode rounds, the grammar) with ``OnlineSession``. The same numpy weights
go to both packages (``params_from_numpy``); both use the tiny tokenizer.

Tolerances: logits 1e-4 (float32 on both sides, only summation order and
transcendental rounding differ); cache rows a step did not write are
identical, the rows it wrote agree to 1e-4 (dense) or in scale to 1e-5
relative and in value to one int8 step (each package quantizes its own k
and v); greedy ids, the order of every ``decode`` call (which fixes the
schedule), the strings and ``cb.steps`` identical. Sampled output is held
within the port (reproducible from the seed, inside the vocabulary and the
grammar): the two packages draw different random numbers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.serving_batch import ContinuousBatcher as JBatcher
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch.checkpoint.bridge import (
    kv_cache_from_numpy,
    params_from_numpy,
)
from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.models import llama as tllama
from a3vlm_tpu_torch.ops.decode_attention import QuantizedKV
from a3vlm_tpu_torch.serving_batch import (
    ContinuousBatcher,
    _bucket,
    _lookup_draft,
)

torch.set_num_threads(1)
ATOL = 1e-4
PROMPTS = [
    "### Human: detect all manipulable object parts",
    "the answer is",
    "provide the joint's type and its 2D rotated bounding box",
    "rotated bounding box rotated bounding box",
    "Hi my darling",
]
GENS = [6, 4, 9, 5, 7]


class _Recording:
    """Tokenizer proxy that records the id lists passed to decode: the
    batcher decodes each request's tail at every token when stop strings
    are given, and every request's ids at the end, so equal records mean
    equal ids in the same schedule."""

    def __init__(self, tok):
        self._tok = tok
        self.decoded = []

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self._tok.decode(ids)

    def __getattr__(self, name):
        return getattr(self._tok, name)


def _args(vocab: int, max_seq_len: int = 96, cls=ModelArgs):
    return cls(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, vocab_size=vocab,
               multiple_of=16, max_seq_len=max_seq_len, max_batch_size=4)


@pytest.fixture(scope="module")
def setup(tiny_tokenizer):
    """One decoder's weights, drawn with numpy in the JAX init's tree, in
    both packages; the joint grammar compiled by each package."""
    vocab = -(-tiny_tokenizer.n_words // 128) * 128
    jargs = _args(vocab, 192, JModelArgs)
    rng = np.random.default_rng(13)
    shapes = jax.eval_shape(lambda k: jllama.init_llama_params(k, jargs),
                            jax.random.PRNGKey(0))
    def draw(path, x):
        name = jax.tree_util.keystr(path)
        if "norm" in name:
            return 1.0 + 0.1 * rng.standard_normal(x.shape)
        if "tok_embeddings" in name:
            return rng.standard_normal(x.shape)
        return rng.uniform(-1, 1, x.shape) * x.shape[-2] ** -0.5

    tree = jax.tree_util.tree_map_with_path(
        lambda p, x: draw(p, x).astype(np.float32), shapes)
    return {
        "tok": tiny_tokenizer, "vocab": vocab,
        "jparams": jax.tree_util.tree_map(jnp.asarray, tree),
        "tparams": params_from_numpy(tree, device="cpu"),
        "jfsm": jconstrained.compile_grammar(jconstrained.joint_rec_grammar(),
                                             tiny_tokenizer),
        "tfsm": tconstrained.compile_grammar(tconstrained.joint_rec_grammar(),
                                             tiny_tokenizer),
        "dfa": tconstrained.CharDfa(tconstrained.Seq(
            tconstrained.Opt(tconstrained.Lit(" ")),
            tconstrained.joint_rec_grammar())),
    }


def _batchers(setup, max_seq_len=96, **kw):
    """(JAX batcher, port batcher) over the same weights, each with a
    recording tokenizer; ``fsm=True`` gives each its package's grammar."""
    fsm = kw.pop("fsm", False)
    jtok, ttok = _Recording(setup["tok"]), _Recording(setup["tok"])
    vocab = setup["vocab"]
    common = dict(vocab_limit=setup["tok"].n_words, **kw)
    jb = JBatcher(setup["jparams"], _args(vocab, max_seq_len, JModelArgs),
                  jtok, fsm=setup["jfsm"] if fsm else None, **common)
    tb = ContinuousBatcher(setup["tparams"], _args(vocab, max_seq_len),
                           ttok, fsm=setup["tfsm"] if fsm else None,
                           device="cpu", **common)
    return jb, tb


# -- the ragged steps ---------------------------------------------------------


def _pool_numpy(setup, B, S, kv_bits, seed):
    """A pool's layered cache filled with seeded values, as numpy layers
    (dense, or (int8 values, scales))."""
    rng = np.random.default_rng(seed)
    shape = (B, 2, S, 16)

    def layer():
        x = rng.standard_normal(shape).astype(np.float32)
        if kv_bits != 8:
            return x
        scale = np.abs(x).max(-1) / 127.0
        return (np.clip(np.round(x / scale[..., None]), -127, 127).astype(
            np.int8), scale.astype(np.float32))

    return [layer() for _ in range(2)], [layer() for _ in range(2)]


def _jax_cache(k_layers, v_layers):
    def layer(x):
        if isinstance(x, tuple):
            from a3vlm_tpu.ops.decode_attention import QuantizedKV as JQ

            return JQ(jnp.asarray(x[0]), jnp.asarray(x[1]))
        return jnp.asarray(x)

    return jllama.KVCache(k=tuple(layer(x) for x in k_layers),
                          v=tuple(layer(x) for x in v_layers))


def _hold_cache(tcache, jcache, written):
    """Rows the step did not write are identical in both; the written rows
    (``written`` [B, Hkv, S] bool) agree as each package's own rounding
    allows."""
    jk = jax.tree_util.tree_map(np.asarray, (jcache.k, jcache.v))
    for t_layers, j_layers in zip((tcache.k, tcache.v), jk):
        for t, j in zip(t_layers, j_layers):
            if isinstance(t, QuantizedKV):
                qv, scale = t.qv.numpy(), t.scale.numpy()
                np.testing.assert_array_equal(qv[~written], j[0][~written])
                np.testing.assert_array_equal(scale[~written],
                                              j[1][~written])
                np.testing.assert_allclose(scale[written], j[1][written],
                                           rtol=1e-5)
                step = np.abs(qv[written].astype(np.int32)
                              - j[0][written].astype(np.int32))
                assert step.max() <= 1
            else:
                t = t.numpy()
                np.testing.assert_array_equal(t[~written], j[~written])
                np.testing.assert_allclose(t[written], j[written], atol=ATOL,
                                           rtol=0)


@pytest.mark.parametrize("kv_bits", [None, 8], ids=["dense", "int8"])
@pytest.mark.parametrize("T", [1, 4])
def test_ragged_steps_match_jax(setup, kv_bits, T):
    """``decode_step_ragged`` (T 1) and ``decode_step_ragged_multi`` (T 4)
    with every row at its own position (one at 0 with one valid row, one
    whose window ends on the pool's last row) over the same cache as the
    JAX steps: the logits, and the cache rows written and untouched."""
    B, S = 4, 48
    pos = np.array([0, 7, 21, S - T], np.int32)
    tokens = np.random.default_rng(3).integers(
        3, setup["tok"].n_words, (B, T)).astype(np.int32)
    layers = _pool_numpy(setup, B, S, kv_bits, seed=T)
    jcache = _jax_cache(*layers)
    tcache = kv_cache_from_numpy(*layers, device="cpu")
    jargs = _args(setup["vocab"], 96, JModelArgs)
    targs = _args(setup["vocab"])
    if T == 1:
        want, jcache = jllama.decode_step_ragged(
            setup["jparams"], jargs, jcache, jnp.asarray(tokens),
            jnp.asarray(pos))
        step = tllama.decode_step_ragged
    else:
        want, jcache = jllama.decode_step_ragged_multi(
            setup["jparams"], jargs, jcache, jnp.asarray(tokens),
            jnp.asarray(pos))
        step = tllama.decode_step_ragged_multi
    with torch.inference_mode():
        got, tcache = step(setup["tparams"], targs, tcache,
                           torch.tensor(tokens), torch.tensor(pos))
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL,
                               rtol=0)
    written = np.zeros((B, 2, S), bool)
    for b in range(B):
        written[b, :, pos[b]: pos[b] + T] = True
    _hold_cache(tcache, jcache, written)


def test_ragged_step_uniform_equals_decode_step(setup):
    """Every row at one position: the ragged step gives the scalar step's
    logits and cache bit for bit (the same ops, the positions as a row)."""
    layers = _pool_numpy(setup, 2, 32, None, seed=5)
    a = kv_cache_from_numpy(*layers, device="cpu")
    b = kv_cache_from_numpy(*layers, device="cpu")
    token = torch.tensor([[11], [40]])
    targs = _args(setup["vocab"])
    with torch.inference_mode():
        want, a = tllama.decode_step(setup["tparams"], targs, a, token, 12)
        got, b = tllama.decode_step_ragged(setup["tparams"], targs, b, token,
                                           torch.tensor([12, 12]))
    assert torch.equal(got, want)
    for x, y in zip((*a.k, *a.v), (*b.k, *b.v)):
        assert torch.equal(x, y)


def test_ragged_multi_equals_serial_steps(setup):
    """The T-token verify step equals T one-token ragged steps position for
    position, logits and cache (the bedrock of speculative batching)."""
    layers = _pool_numpy(setup, 2, 40, None, seed=6)
    multi = kv_cache_from_numpy(*layers, device="cpu")
    serial = kv_cache_from_numpy(*layers, device="cpu")
    window = torch.tensor([[5, 9, 13], [21, 3, 8]])
    pos = torch.tensor([7, 30])
    targs = _args(setup["vocab"])
    with torch.inference_mode():
        lg_multi, multi = tllama.decode_step_ragged_multi(
            setup["tparams"], targs, multi, window, pos)
        for j in range(3):
            lg, serial = tllama.decode_step_ragged(
                setup["tparams"], targs, serial, window[:, j: j + 1],
                pos + j)
            np.testing.assert_allclose(lg.numpy(), lg_multi[:, j].numpy(),
                                       atol=ATOL, rtol=0)
    for x, y in zip((*multi.k, *multi.v), (*serial.k, *serial.v)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=1e-5, rtol=0)


# -- the batcher against JAX's ------------------------------------------------


# mode: (batcher options, generate options)
MODES = {
    "vanilla": (dict(slots=2), dict(additional_stop_symbols=("###",))),
    "kv8": (dict(slots=2, kv_cache_bits=8), {}),
    "draft3": (dict(slots=2, draft_k=3),
               dict(additional_stop_symbols=("###",))),
    "fsm": (dict(slots=2, fsm=True), {}),
    "steps4": (dict(slots=2, steps_per_dispatch=4), {}),
    "batched4": (dict(slots=4), {}),
    "draft4_kv8_fsm": (dict(slots=3, draft_k=4, kv_cache_bits=8, fsm=True),
                       {}),
}


@pytest.mark.parametrize("mode", list(MODES))
def test_generate_matches_jax(setup, mode):
    """Five ragged prompts with ragged ``max_gen_len`` through the pool:
    the strings, every decode call (ids and schedule) and the step count
    equal the JAX batcher's; the pool overlapped requests."""
    opts, gen_kw = MODES[mode]
    grammar = opts.get("fsm", False)
    gens = [24, 16, 30, 20, 12] if grammar else GENS
    jb, tb = _batchers(setup, 192 if grammar else 96, **opts)
    want = jb.generate(PROMPTS, max_gen_len=gens, **gen_kw)
    got = tb.generate(PROMPTS, max_gen_len=gens, **gen_kw)
    assert got == want
    assert tb.tokenizer.decoded == jb.tokenizer.decoded
    assert tb.steps == jb.steps
    assert 0 < tb.steps < sum(gens)
    s = tb.last_stats
    assert s["requests"] == len(PROMPTS) and s["tokens"] > len(PROMPTS)
    assert 0 <= s["ttft_p50_s"] <= s["ttft_p95_s"]


@pytest.mark.parametrize("draft_k", [0, 3])
def test_prefix_admission_matches_jax(setup, draft_k):
    """A shared text prefix (``make_prefix``): every question admits as an
    extension of it, grouped by bucket; equal to the JAX batcher's."""
    jb, tb = _batchers(setup, slots=2, draft_k=draft_k)
    pre = setup["tok"].encode("### Human: please", bos=False, eos=False)
    questions = ["detect the door", "status of the drawer",
                 "the answer is the answer is", "Hi"]
    want = jb.generate(questions, max_gen_len=[6, 8, 5, 7],
                       prefixes=[jb.make_prefix(tokens=pre)] * 4)
    prefix = tb.make_prefix(tokens=pre)
    assert prefix.length == 1 + len(pre)
    got = tb.generate(questions, max_gen_len=[6, 8, 5, 7],
                      prefixes=[prefix] * 4)
    assert got == want
    assert tb.tokenizer.decoded == jb.tokenizer.decoded
    assert tb.steps == jb.steps


def test_slot_near_the_pool_end(setup):
    """Requests that fill the pool to its last row, one through a non-/8
    prefix (the exact-length admission), with verify windows reaching into
    the spare rows: the same output as the JAX batcher's, and no write
    outside the pool."""
    tok = setup["tok"]
    pre = tok.encode("open the door please see the status of all parts now "
                     "ok", bos=False, eos=False)
    plen = 1 + len(pre)
    text = " ".join(["detect"] * (96 - 4 - plen))
    n_text = len(tok.encode(text, bos=False, eos=False))
    assert plen % 8 and plen + n_text + 4 == 96
    assert -(-(plen + _bucket(n_text)) // 8) * 8 > 96
    for draft_k in (0, 3):
        jb, tb = _batchers(setup, slots=2, draft_k=draft_k)
        want = jb.generate([text, "the answer is"], max_gen_len=[4, 30],
                           prefixes=[jb.make_prefix(tokens=pre), None])
        got = tb.generate([text, "the answer is"], max_gen_len=[4, 30],
                          prefixes=[tb.make_prefix(tokens=pre), None])
        assert got == want and tb.steps == jb.steps
        assert tb.cache.k[0].shape[2] >= 96 + (draft_k + 1 if draft_k
                                               else 0)


# -- the port's own invariants -----------------------------------------------


def _greedy_reference(setup, toks, max_gen_len, args):
    """One request alone through ``prefill`` and ``decode_step``, greedy
    over the true vocabulary, cut at EOS."""
    tok, params = setup["tok"], setup["tparams"]
    with torch.inference_mode():
        cache = tllama.KVCache.create(args, 1, args.max_seq_len,
                                      dtype=torch.float32, device="cpu")
        logits, cache, _ = tllama.prefill(params, args, cache,
                                          torch.tensor([toks]))
        out = [int(logits[0, : tok.n_words].argmax())]
        pos = len(toks)
        while out[-1] != tok.eos_id and len(out) < max_gen_len:
            logits, cache = tllama.decode_step(
                params, args, cache, torch.tensor([[out[-1]]]), pos)
            out.append(int(logits[0, : tok.n_words].argmax()))
            pos += 1
    if tok.eos_id in out:
        out = out[: out.index(tok.eos_id)]
    return tok.decode(out)


@pytest.mark.parametrize("seed,draft_k", [(11, 0), (12, 0), (11, 3),
                                          (13, 5)])
def test_fuzz_schedules_match_per_request(setup, seed, draft_k):
    """Random workloads (ragged prompts and limits, 1-3 slots) equal each
    request decoded alone (serving tests' fuzz schedules, in the port)."""
    rng = np.random.default_rng(seed)
    tok = setup["tok"]
    words = ["detect", "parts", "joint", "box", "the", "answer", "is",
             "rotated", "bounding", "Hi", "darling", "###", "Human:"]
    n = int(rng.integers(4, 8))
    prompts = [" ".join(rng.choice(words, size=int(rng.integers(2, 14))))
               for _ in range(n)]
    gens = [int(g) for g in rng.integers(1, 8, size=n)]
    slots = int(rng.integers(1, 4))
    args = _args(setup["vocab"])
    want = [_greedy_reference(setup, tok.encode(p, bos=True, eos=False), g,
                              args) for p, g in zip(prompts, gens)]
    got = ContinuousBatcher(setup["tparams"], args, tok, slots=slots,
                            vocab_limit=tok.n_words, draft_k=draft_k,
                            device="cpu").generate(prompts, max_gen_len=gens)
    assert got == want, (slots, gens, draft_k)


@pytest.mark.parametrize("draft_k", [0, 3])
def test_online_session_matches_generate(setup, draft_k):
    """``OnlineSession`` with late submissions gives generate()'s output;
    a queued request polls empty and not done, a running one partial."""
    tok, args = setup["tok"], _args(setup["vocab"])

    def batcher():
        return ContinuousBatcher(setup["tparams"], args, tok, slots=2,
                                 vocab_limit=tok.n_words, draft_k=draft_k,
                                 device="cpu")

    want = batcher().generate(PROMPTS, max_gen_len=GENS)
    sess = batcher().online()
    rids = [sess.submit(p, max_gen_len=g) for p, g in zip(PROMPTS[:3],
                                                          GENS[:3])]
    sess.step()
    running, queued = sess.poll(rids[0]), sess.poll(rids[2])
    assert len(running["tokens"]) >= 1 and not running["done"]
    assert queued == {"done": False, "tokens": [], "text": ""}
    sess.step()
    rids += [sess.submit(p, max_gen_len=g) for p, g in zip(PROMPTS[3:],
                                                           GENS[3:])]
    sess.drain()
    got = [sess.poll(r) for r in rids]
    assert all(g["done"] for g in got)
    assert [g["text"] for g in got] == want
    s = sess.stats()
    assert s["requests"] == len(PROMPTS)
    assert all(p["ttft_s"] >= 0 for p in s["per_request"])


@pytest.mark.parametrize("opts", [dict(), dict(steps_per_dispatch=3),
                                  dict(fsm=True)],
                         ids=["vanilla", "steps3", "fsm"])
def test_sampled_runs(setup, opts):
    """temperature 0.8: the same seed gives the same samples, another seed
    other ones; every id inside the true vocabulary; under the grammar
    every answer parses."""
    tok, args = setup["tok"], _args(setup["vocab"], 192)
    fsm = setup["tfsm"] if opts.pop("fsm", False) else None

    def run(seed):
        rec = _Recording(tok)
        cb = ContinuousBatcher(setup["tparams"], args, rec, slots=2,
                               vocab_limit=tok.n_words, seed=seed, fsm=fsm,
                               device="cpu", **opts)
        out = cb.generate(PROMPTS, max_gen_len=64 if fsm else 12,
                          temperature=0.8, top_p=0.9)
        return out, rec.decoded

    a, ids = run(0)
    assert run(0) == (a, ids)
    assert run(1)[0] != a
    assert all(0 <= i < tok.n_words for row in ids for i in row)
    if fsm is not None:
        for text in a:
            assert setup["dfa"].matches(text), text


@pytest.mark.parametrize("opts", [dict(), dict(draft_k=3),
                                  dict(steps_per_dispatch=3),
                                  dict(prefix=True)],
                         ids=["vanilla", "draft3", "steps3", "prefix"])
def test_warmup_is_transparent(setup, opts):
    """``warmup`` runs every admission shape and a decode round, then
    leaves the pool idle at position 0 with its step count and generator
    as they were: the same output as a cold pool, greedy and sampled."""
    tok, args = setup["tok"], _args(setup["vocab"])
    use_prefix = opts.pop("prefix", False)
    pre = tok.encode("### system", bos=False, eos=False)

    def run(warm, temperature):
        cb = ContinuousBatcher(setup["tparams"], args, tok, slots=2,
                               vocab_limit=tok.n_words, device="cpu", **opts)
        kw = {}
        if use_prefix:
            kw["prefixes"] = [cb.make_prefix(tokens=pre)] * len(PROMPTS)
        if warm:
            cb.warmup(buckets=(4, 8, 16), groups=(1, 2),
                      prefix_len=1 + len(pre) if use_prefix else None,
                      temperature=temperature, top_p=0.9)
            assert cb.steps == 0 and all(a is None for a in cb._active)
            assert not cb._host_pos.any()
        return cb.generate(PROMPTS, max_gen_len=GENS,
                           temperature=temperature, top_p=0.9, **kw)

    assert run(True, 0.0) == run(False, 0.0)
    if not opts.get("draft_k"):
        assert run(True, 0.8) == run(False, 0.8)


def test_lookup_draft_longest_suffix_wins():
    ctx = [5, 2, 3, 4, 9, 9, 1, 3, 4, 8, 5, 2, 3, 4]
    assert _lookup_draft(ctx, 3) == [9, 9, 1]
    assert _lookup_draft([1, 3, 4, 8, 0, 6, 3, 4], 2) == [8, 0]
    assert _lookup_draft([7, 7, 5], 3) == [5, 5, 5]
    assert _lookup_draft([2, 6, 9, 2, 6], 3) == [9, 2, 6]


def test_refusals(setup):
    tok, args = setup["tok"], _args(setup["vocab"])
    kw = dict(vocab_limit=tok.n_words, device="cpu")
    # a mesh is taken (tests/test_torch_parallel_batch.py); a mesh of one
    # rank is the unsharded pool
    from a3vlm_tpu_torch.parallel import create_mesh

    cb = ContinuousBatcher(setup["tparams"], args, tok,
                           mesh=create_mesh(1, ["cpu"]), **kw)
    assert cb._slot0 == 0 and cb.cache.k[0].shape[:2] == (4, 2)
    with pytest.raises(ValueError, match="lie on"):
        ContinuousBatcher(setup["tparams"], args, tok, vocab_limit=5,
                          device="cuda")
    with pytest.raises(ValueError, match="greedy"):
        ContinuousBatcher(setup["tparams"], args, tok, draft_k=2,
                          **kw).generate(["hi"], temperature=0.5)
    with pytest.raises(ValueError, match="pool"):
        ContinuousBatcher(setup["tparams"], args, tok, **kw).generate(
            ["hi"], max_gen_len=200)
