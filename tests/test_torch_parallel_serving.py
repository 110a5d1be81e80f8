"""The port's ``ModelServer(model_parallel_size=2)`` against the JAX
package's on the tiny llama_ens5 checkpoint of tests/test_torch_eval.py
(its fixtures, imported), on the CPU: the port's two ranks are gloo
processes (this one rank 0), the JAX server's mesh model 2 over its 8 CPU
devices, served from a loaded ``MetaModel`` (``meta_model=``, the eval
CLI's form). ``from_pretrained`` with ``quant=True`` (the chunk-packed
row-parallel tree) and the ranks' lifetime: test_torch_parallel_serving_quant.py.

Tolerances: float32 on both sides; greedy strings, the streamed chunks and
``run_eval``'s results JSON identical, every rank's ids identical to rank
0's; ``compute_logits`` and ``evaluate_examples`` to 1e-4 (summation order
differs)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_eval import (  # noqa: F401 (fixtures)
    MAX_SEQ,
    SIZE,
    ckpt,
    tiny_towers,
)

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.serving import ModelServer as JServer
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.serving import ModelServer

torch.set_num_threads(1)
ATOL = 1e-4
CPU2 = ["cpu"] * 2
PROMPTS = ["Please provide the joint's type and its 2D rotated bounding "
           "box linked to the object part door", "hello lid"]


def _images(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def servers(tiny_towers, ckpt):
    """Each package's server over its own float32 load of the checkpoint,
    at model_parallel_size 2."""
    jm = JMetaModel.from_pretrained(str(ckpt), with_visual=True,
                                    max_seq_len=MAX_SEQ, dtype=jnp.float32)
    tm = MetaModel.from_pretrained(str(ckpt), with_visual=True,
                                   max_seq_len=MAX_SEQ, dtype=torch.float32,
                                   device="cpu")
    ts = ModelServer(meta_model=tm, model_parallel_size=2, devices=CPU2)
    yield JServer(meta_model=jm, model_parallel_size=2), ts
    ts.close()


def test_server_splits_the_model_over_two_ranks(servers):
    _, ts = servers
    assert ts.backend == "gloo" and ts.mesh.mp_size == 2
    states = ts.map_ranks(ranks.rank_state)
    assert [s["rank"] for s in states] == [0, 1]
    # wq's 64 output columns split in two
    assert [s["wq_columns"] for s in states] == [32, 32]


@pytest.mark.parametrize("kw", [{}, {"images": True}, {"grammar": True},
                                {"draft_k": 2}],
                         ids=["text", "images", "grammar", "draft2"])
def test_generate_matches_jax(servers, kw):
    js, ts = servers
    prompts = PROMPTS[:1] if "draft_k" in kw else PROMPTS
    jkw, tkw = dict(max_gen_len=12, temperature=0.0), {}
    if kw.get("images"):
        jkw["images"] = _images(len(prompts))
    if kw.get("grammar"):
        jkw["fsm"] = jconstrained.fsm_for_task("joint_rec", js.model.tokenizer)
        tkw["fsm"] = tconstrained.fsm_for_task("joint_rec",
                                               ts.model.tokenizer)
        jkw["max_gen_len"] = 40
    if "draft_k" in kw:
        jkw["draft_k"] = kw["draft_k"]
    want = js.generate(prompts, **jkw)
    assert ts.generate(prompts, **{**jkw, **tkw}) == want


def test_every_rank_picks_the_same_ids(servers):
    _, ts = servers
    ids = [ts.model.tokenizer.encode(p, bos=True, eos=False)
           for p in PROMPTS]
    out = ts.map_ranks(ranks.generate_ids, ids, images=_images(2, 7),
                       max_gen_len=8, temperature=0.7, seed=5)
    assert out[1] == out[0] and len(out[0]) == 2


def test_stream_generate_matches_jax(servers):
    js, ts = servers
    kw = dict(image=_images(1, seed=4)[0], max_gen_len=10, temperature=0.0)
    want = list(js.stream_generate(PROMPTS[0], **kw))
    assert list(ts.stream_generate(PROMPTS[0], **kw)) == want
    # a stream read in part leaves the ranks in step for the next call
    for _ in zip(range(2), ts.stream_generate(PROMPTS[1], **kw)):
        pass
    assert list(ts.stream_generate(PROMPTS[0], **kw)) == want


def test_scoring_apis_match_jax(servers):
    js, ts = servers
    kw = {"images": _images(2, seed=5)}
    for a, b in zip(ts.compute_logits(PROMPTS, **kw),
                    js.compute_logits(PROMPTS, **kw)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    contexts = ["Please provide the joint's type", "hello"]
    got = ts.evaluate_examples(PROMPTS, contexts=contexts, **kw)
    want = js.evaluate_examples(PROMPTS, contexts=contexts, **kw)
    for k in ("log_likelihood", "ppl"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
    assert got["max_equal"] == want["max_equal"]
