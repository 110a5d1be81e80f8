"""The port's ``ModelServer`` against the JAX package's at
``model_parallel_size=1``, on the tiny llama_ens5 checkpoint that
``tests/test_torch_eval.py`` writes (its fixtures, imported): served from a
loaded ``MetaModel`` (``meta_model=``) and through ``from_pretrained``
(with ``quant=True`` and ``kv_cache_bits=8``), on ``device="cpu"``.

Tolerances: float32 on both sides (the ``from_pretrained`` route held to
float32 as in tests/test_torch_serving_eval.py); greedy strings, every
``decode`` call and the streamed chunks identical, ``run_eval``'s results
JSON byte for byte; ``compute_logits`` and ``evaluate_examples`` to 1e-4
(summation order differs)."""

import json

import numpy as np
import pytest
import torch
from test_torch_eval import (  # noqa: F401 (fixtures)
    MAX_SEQ,
    SIZE,
    ckpt,
    models,
    tasks,
    tiny_towers,
)
from test_torch_serving_batch import _Recording
from test_torch_serving_eval import float32_loads  # noqa: F401 (fixture)

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu.serving import ModelServer as JServer
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch.serving import ModelServer

torch.set_num_threads(1)
ATOL = 1e-4
PROMPTS = ["Please provide the joint's type and its 2D rotated bounding "
           "box linked to the object part door", "hello lid"]


def _images(n: int, seed: int = 3) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def _recorded(model):
    """Puts a recording proxy in place of the model's tokenizer (the
    server's constructor drops the cached generator that holds the old
    one)."""
    rec = model.tokenizer
    if not isinstance(rec, _Recording):
        rec = _Recording(model.tokenizer)
        model.tokenizer = rec
    rec.decoded.clear()
    return rec


@pytest.fixture(scope="module")
def servers(models):
    jm, tm = models
    jrec, trec = _recorded(jm), _recorded(tm)
    return (JServer(meta_model=jm, model_parallel_size=1),
            ModelServer(meta_model=tm, device="cpu"), jrec, trec)


@pytest.mark.parametrize("kw", [{}, {"images": True}, {"grammar": True},
                                {"draft_k": 2}],
                         ids=["text", "images", "grammar", "draft2"])
def test_generate_matches_jax(servers, kw):
    """Strings and every ``decode`` call equal; ``generate``'s keywords
    (``fsm``, ``draft_k``) flow through to the model."""
    js, ts, jrec, trec = servers
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
    jrec.decoded.clear()
    trec.decoded.clear()
    want = js.generate(prompts, **jkw)
    got = ts.generate(prompts, **{**jkw, **tkw})
    assert got == want
    assert trec.decoded == jrec.decoded and len(trec.decoded) == len(prompts)


def test_stream_generate_matches_jax(servers):
    js, ts, _, _ = servers
    image = _images(1, seed=4)[0]
    for stops in ((), ("\n###",)):
        kw = dict(image=image, max_gen_len=10, temperature=0.0,
                  additional_stop_symbols=stops)
        want = list(js.stream_generate(PROMPTS[0], **kw))
        got = list(ts.stream_generate(PROMPTS[0], **kw))
        assert got == want and got[-1]["end_of_content"]


def test_compute_logits_matches_jax(servers):
    js, ts, _, _ = servers
    for kw in ({}, {"images": _images(2, seed=5)}):
        want = js.compute_logits(PROMPTS, **kw)
        got = ts.compute_logits(PROMPTS, **kw)
        assert len(got) == len(want) == 2
        for a, b in zip(got, want):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_evaluate_examples_matches_jax(servers):
    js, ts, _, _ = servers
    contexts = ["Please provide the joint's type", "hello"]
    kw = dict(contexts=contexts, images=_images(2, seed=6))
    want = js.evaluate_examples(PROMPTS, **kw)
    got = ts.evaluate_examples(PROMPTS, **kw)
    for k in ("log_likelihood", "ppl"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
    assert got["max_equal"] == want["max_equal"]
    for a, b in zip(got["non_context_logits"], want["non_context_logits"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


@pytest.mark.parametrize("quant,kv_cache_bits", [(False, None), (True, 8)],
                         ids=["dense", "int4_kv8"])
def test_from_pretrained_server_matches_jax(float32_loads, ckpt, tasks,
                                            quant, kv_cache_bits):
    """Each package's server loads the checkpoint itself; the task file
    through ``run_eval`` over each server gives the same results JSON, with
    the same ``decode`` calls."""
    kw = dict(pretrained_path=str(ckpt), max_seq_len=MAX_SEQ, quant=quant,
              kv_cache_bits=kv_cache_bits)
    js = JServer(**kw)
    ts = ModelServer(**kw, device="cpu")
    assert ts.model.device.type == "cpu"
    assert ts.model.kv_cache_bits == js.model.kv_cache_bits == kv_cache_bits
    jrec, trec = _recorded(js.model), _recorded(ts.model)
    js.model._generator = ts.model._generator = None
    run = dict(batch_size=2, max_gen_len=16, temperature=0.0)
    want = jeval.run_eval(js, jeval.VQADataset(tasks, input_size=SIZE), **run)
    got = teval.run_eval(ts, teval.VQADataset(tasks, input_size=SIZE), **run)
    assert json.dumps(got) == json.dumps(want) and len(got) == 6
    assert trec.decoded == jrec.decoded


def test_several_devices_name_their_item(ckpt):
    """Several devices are ported (tests/test_torch_parallel_serving.py);
    what raises now is a mesh the devices cannot hold: two ranks wanted,
    no card visible here and one device named."""
    for devices in (None, ["cpu"]):
        with pytest.raises(ValueError, match="needs as many devices"):
            ModelServer(pretrained_path=str(ckpt), model_parallel_size=2,
                        devices=devices)


def test_server_defaults_to_the_card():
    import inspect

    sig = inspect.signature(ModelServer.__init__)
    assert sig.parameters["device"].default == "cuda"
    assert list(sig.parameters)[1:9] == list(inspect.signature(
        JServer.__init__).parameters)[1:]
