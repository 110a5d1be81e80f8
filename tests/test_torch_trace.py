"""The port's span recorder (``a3vlm_tpu_torch/utils/trace.py``) and the
spans and counters of the generate path: spans nest under one call id;
the generated ids equal the JAX ``Generator``'s; ``last_stats``'s four
old numbers keep their meaning (each the host interval around the same
work, ``decode_steps`` the decode calls made); the row-step counters
equal the arithmetic of the prompt lengths, ``max_gen_len`` and the
stops; under ``torch.profiler`` a span's range lies inside its stamps;
the mesh's ``collective:*`` names are kept."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_families import numpy_tree

from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.generation import Generator as JGenerator
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.generation import Generator, row_steps
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import internlm_ems5_light as til
from a3vlm_tpu_torch.parallel import create_mesh
from a3vlm_tpu_torch.parallel import mesh as tmesh
from a3vlm_tpu_torch.utils import trace

VOCAB, LIMIT, EOS = 256, 250, 255  # EOS past the limit: never chosen
TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2, multiple_of=16,
            rope_theta=1e6)


# ------------------------------------------------------------- the recorder


def test_spans_nest_under_one_call_id():
    with trace.span("outside"):
        trace.count("outside")  # no call open: nothing recorded
    with trace.call("root") as rec:
        with trace.span("a", k=1):
            with trace.span("b"):
                pass
            with trace.call("joined") as inner:
                assert inner is rec
                with trace.span("c"):
                    trace.count("n", 2)
        with trace.span("d"):
            trace.count("n")
    assert [s.name for s in rec.spans] == ["root", "a", "b", "c", "d"]
    assert [s.parent for s in rec.spans] == [-1, 0, 1, 1, 0]
    assert rec.spans[1].attrs == {"k": 1}
    assert rec.counters == {"n": 3}
    for s in rec.spans:
        parent = rec.spans[s.parent] if s.parent >= 0 else None
        assert s.start_ns <= s.end_ns
        if parent is not None:
            assert parent.start_ns <= s.start_ns <= s.end_ns <= parent.end_ns
    with trace.call("root") as again:
        pass
    assert again.call_id != rec.call_id and len(again.spans) == 1


def test_device_span_off_the_card_reads_host_ms():
    with trace.call("root") as rec:
        with trace.span("dev", device=torch.device("cpu")):
            torch.ones(64).sum()
        with trace.span("host"):
            pass
    dev, host = rec.spans[1], rec.spans[2]
    assert dev.device_ms == dev.host_ms and host.device_ms is None


def test_stamps_on_the_profilers_clock():
    """Under ``torch.profiler`` (CPU activity) every span's
    ``record_function`` event lies inside the span's own stamps."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.call("root") as rec:
            for i in range(5):
                with trace.span("step", i=i):
                    torch.ones(256, 256).sum()
    events = sorted((e.start_ns(), e.start_ns() + e.duration_ns())
                    for e in prof.profiler.kineto_results.events()
                    if e.name() == "step")
    spans = [(s.start_ns, s.end_ns) for s in rec.named("step")]
    assert len(events) == len(spans) == 5
    for (es, ee), (ss, se) in zip(events, spans):
        assert ss <= es <= ee <= se


def test_collective_spans_keep_their_names():
    """``parallel/mesh.py``'s collectives are the recorder's spans, named
    ``collective:<name>``: in the open call and in a profiler trace."""
    from torch.profiler import ProfilerActivity, profile

    mesh = create_mesh(1, ["cpu"])
    x = torch.ones(4)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with trace.call("root") as rec:
            tmesh.all_reduce(x, mesh)
            tmesh.all_gather(x, mesh)
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"collective:all_reduce", "collective:all_gather"} <= names
    assert [s.name for s in rec.spans[1:]] == ["collective:all_reduce",
                                               "collective:all_gather"]


# ------------------------------------------------- the vanilla decode loop


class _Tok:
    """A tokenizer over fixed ids: prompt ``name`` encodes to
    ``ids[name]``, stop symbol ``"s<id>"`` to ``(id,)``; ``decode`` keeps
    the ids it is given."""

    eos_id = EOS
    n_words = LIMIT

    def __init__(self, ids):
        self.ids = ids
        self.decoded = []

    def encode(self, s, bos, eos):
        return list(self.ids[s])

    def encode_segment(self, s):
        return [int(s[1:])]

    encode_wo_prefix_space = encode_segment

    def decode(self, ids):
        self.decoded.append(list(ids))
        return ""


@pytest.fixture(scope="module")
def decoders():
    jargs = JModelArgs(vocab_size=VOCAB, max_seq_len=64, **TINY)
    tree = numpy_tree(jllama.init_llama_params, jargs, 31)
    targs = ModelArgs(vocab_size=VOCAB, max_seq_len=64, **TINY)
    return (jax.tree_util.tree_map(jnp.asarray, tree), jargs,
            params_from_numpy(tree, device="cpu"), targs)


def _bracket(obj, name, log):
    """Wrap ``obj.name`` to log (name, entry stamp, exit stamp, its
    arguments) on the recorder's clock."""
    fn = getattr(obj, name)

    def run(*a, **kw):
        rec = trace._local.rec
        t0 = trace._now() + rec.offset_ns
        out = fn(*a, **kw)
        log.append((name, t0, trace._now() + rec.offset_ns, a))
        return out

    setattr(obj, name, run)


def _run(decoders, lens, max_gen_len, stops=(), seed=0):
    """(JAX ids, the port's ids, its Generator, the record of its call, the
    (name, stamp in, stamp out, position) of each prefill and decode call
    it made) for prompts of ``lens`` ids and stop symbols ``stops``."""
    jp, jargs, tp, targs = decoders
    rng = np.random.default_rng(seed)
    ids = {f"p{i}": [1] + rng.integers(3, LIMIT, n - 1).tolist()
           for i, n in enumerate(lens)}
    jtok, ttok = _Tok(ids), _Tok(ids)
    JGenerator(jp, jargs, jtok, vocab_limit=LIMIT).generate(
        list(ids), max_gen_len=max_gen_len, additional_stop_symbols=stops)
    gen = Generator(tp, targs, ttok, vocab_limit=LIMIT)
    calls = []
    _bracket(gen, "_prefill", calls)
    _bracket(gen, "_decode", calls)
    with trace.call("probe") as rec:
        gen.generate(list(ids), max_gen_len=max_gen_len,
                     additional_stop_symbols=stops)
    return jtok.decoded, ttok.decoded, gen, rec, calls


def _expected_row_steps(lens, outs, P, steps, max_gen_len):
    """The counters by hand, from what the call returned: row i's ids end
    at its prompt length plus the ids returned."""
    forced = asked = 0
    for n, out in zip(lens, outs):
        for q in range(P, P + steps):
            if q < n:
                forced += 1
            elif q - n < max_gen_len and q < n + len(out):
                asked += 1
    return forced, asked, len(lens) * steps - forced - asked


MIXES = {"forced": ([5, 9, 12], 6), "even": ([8, 8], 5),
         "long": ([4, 17, 6, 11], 9)}


@pytest.mark.parametrize("mix", [*MIXES, "stop_midway"])
def test_loop_ids_steps_and_row_counters(decoders, mix):
    lens, max_gen_len = MIXES.get(mix, MIXES["forced"])
    stops = ()
    if mix == "stop_midway":
        # a stop id that row 0 generates at its third id or later: that
        # row stops there, the others run on
        _, free, _, _, _ = _run(decoders, lens, max_gen_len)
        row = free[0]
        k = next(k for k in range(2, len(row)) if row[k] not in row[:k])
        stops = (f"s{row[k]}",)
    want, got, gen, rec, calls = _run(decoders, lens, max_gen_len, stops)
    assert got == want
    if stops:
        assert len(got[0]) < max_gen_len
    st = gen.last_stats
    steps = st["decode_steps"]
    decodes = [c for c in calls if c[0] == "_decode"]
    assert steps == len(decodes)
    P = 1 << (min(lens).bit_length() - 1)
    assert [c[3][2] for c in decodes] == list(range(P, P + steps))
    # prefill_ms and decode_ms: the host intervals around the same work
    (prefill,), (decode,) = rec.named("prefill"), rec.named("decode")
    assert st["prefill_ms"] == prefill.host_ms
    assert st["decode_ms"] == decode.host_ms
    assert prefill.end_ns <= decode.start_ns
    for name, t0, t1, _ in calls:
        span = prefill if name == "_prefill" else decode
        assert span.start_ns <= t0 <= t1 <= span.end_ns
    counters = (st["row_steps_forced"], st["row_steps_asked"],
                st["row_steps_spare"])
    assert counters == _expected_row_steps(lens, got, P, steps, max_gen_len)
    assert sum(counters) == len(lens) * steps
    assert (st["decode_issue_ms"] + st["decode_wait_ms"]
            <= st["decode_ms"])
    for v in st.values():
        assert type(v) in (int, float)


def test_issue_and_wait_spans_per_iteration(decoders):
    lens, max_gen_len = MIXES["forced"]
    _, _, _, rec, calls = _run(decoders, lens, max_gen_len)
    calls = [c for c in calls if c[0] == "_decode"]
    decode = rec.named("decode")[0]
    issue, wait = rec.named("decode.issue"), rec.named("decode.wait")
    # the first issue chooses from the prefill's logits; each later one
    # makes one decode step
    assert len(issue) == len(calls) + 1 and len(wait) == len(calls)
    top = rec.spans.index(decode)
    assert {s.parent for s in issue + wait} == {top}
    P = 1 << (min(lens).bit_length() - 1)
    # forced while the step feeds some row a prompt id
    assert [s.attrs["forced"] for s in issue] == [
        P + k - 1 < max(lens) for k in range(len(issue))]
    ordered = sorted(issue + wait, key=lambda s: s.start_ns)
    assert [s.name for s in ordered[:3]] == ["decode.issue", "decode.wait",
                                             "decode.issue"]
    for a, b in zip(ordered, ordered[1:]):
        assert a.end_ns <= b.start_ns


@pytest.mark.parametrize("stop", [[], [7]])
def test_row_steps_arithmetic(stop):
    # rows of 5 and 9 ids, bucket 4, 10 steps (positions 4..13), 6 asked
    stops = [15, 15] if not stop else [7, 15]
    got = row_steps([5, 9], stops, 4, 10, 6)
    forced = 1 + 5
    asked = (6 if not stop else 2) + 5  # row 9: positions 9..13
    assert got == {"row_steps_forced": forced, "row_steps_asked": asked,
                   "row_steps_spare": 20 - forced - asked}


# ----------------------------------------------------- MetaModel's record


@pytest.fixture(scope="module")
def meta():
    cfg = til.tiny_config(VOCAB)
    return MetaModel("internlm_ems5_light", with_visual=True, vocab_size=LIMIT,
                     model_cfg=cfg, device="cpu", seed=3)


def test_meta_stats_keep_their_meaning(meta):
    """``towers_ms``, ``prefill_ms`` and ``decode_ms`` are the host
    intervals around the towers, the prefill and the loop, in that order,
    as before; the towers' spans sit under ``towers``; every value is a
    plain number."""
    rng = np.random.default_rng(1)
    image = torch.tensor(rng.normal(size=(2, 128, 128, 3)),
                         dtype=torch.float32)
    prompts = [[1] + rng.integers(3, LIMIT, n - 1).tolist() for n in (6, 10)]
    log = []
    meta._generator = None
    gen = meta._get_generator()
    _bracket(meta, "encode_images", log)
    _bracket(gen, "_prefill", log)
    _bracket(gen, "_decode", log)
    try:
        meta.generate_tokens(prompts, images=image, max_gen_len=4,
                             stop_tokens=())
    finally:
        for name in ("encode_images", "_prefill", "_decode"):
            vars(meta).pop(name, None)
            vars(gen).pop(name, None)
    st, rec = meta.last_stats, meta.last_trace
    assert set(st) == {"towers_ms", "prefill_ms", "decode_ms", "decode_steps",
                       "decode_issue_ms", "decode_wait_ms", "row_steps_forced",
                       "row_steps_asked", "row_steps_spare", "convnext_ms",
                       "dinov2_ms"}
    for v in st.values():
        assert type(v) in (int, float)
    assert rec.spans[0].name == "generate" and rec.spans[0].parent == -1
    (towers,), (prefill,), (decode,) = (rec.named(n) for n in (
        "towers", "prefill", "decode"))
    assert st["towers_ms"] == towers.host_ms
    assert st["prefill_ms"] == prefill.host_ms
    assert st["decode_ms"] == decode.host_ms
    assert towers.end_ns <= prefill.start_ns and prefill.end_ns <= \
        decode.start_ns
    spans = {"encode_images": towers, "_prefill": prefill, "_decode": decode}
    for name, t0, t1, _ in log:
        assert spans[name].start_ns <= t0 <= t1 <= spans[name].end_ns
    assert st["decode_steps"] == sum(c[0] == "_decode" for c in log)
    # the longest prompt and every new id but the last, less the bucket
    assert st["decode_steps"] == 10 + 4 - 1 - 4
    ti = rec.spans.index(towers)
    for name in ("towers.crops", "towers.convnext", "towers.dinov2"):
        (s,) = rec.named(name)
        assert s.parent == ti and s.device_ms == s.host_ms
    assert st["convnext_ms"] + st["dinov2_ms"] <= st["towers_ms"]
