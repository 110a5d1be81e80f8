"""The continuous-batching eval path of the port against the JAX package:
``run_eval_continuous`` and ``main --continuous_batching`` on the tiny
llama_ens5 checkpoint that ``tests/test_torch_eval.py`` writes (its
fixtures, imported), and image-conditioned admission through the towers.

Tolerances: at temperature 0 in float32 the results JSON is byte-identical
to the JAX CLI's (both ``from_pretrained`` calls held to float32 here; the
CLI's own default is bf16, which rounds at other places in the two
frameworks); greedy strings, every ``decode`` call and ``cb.steps``
identical."""

import json
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import (  # noqa: F401 (fixtures)
    JOINT_RE,
    MAX_SEQ,
    SIZE,
    ckpt,
    models,
    tasks,
    tiny_towers,
)
from test_torch_serving_batch import _Recording

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.serving_batch import ContinuousBatcher as JBatcher
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.serving_batch import ContinuousBatcher

torch.set_num_threads(1)


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["free", "grammar"])
def test_run_eval_continuous_matches_jax_byte_for_byte(models, tasks,
                                                       constrained):
    """3 renders x 2 questions through a 2-slot pool, one prefix a render:
    the records equal the JAX package's byte for byte."""
    jm, tm = models
    fsm_j = fsm_t = None
    if constrained:
        fsm_j = jconstrained.fsm_for_task("joint_rec", jm.tokenizer)
        fsm_t = tconstrained.fsm_for_task("joint_rec", tm.tokenizer)
    kw = dict(batch_size=2, max_gen_len=64 if constrained else 16,
              temperature=0.0)
    want = jeval.run_eval_continuous(
        jm, jeval.VQADataset(tasks, input_size=SIZE), fsm=fsm_j, **kw)
    got = teval.run_eval_continuous(
        tm, teval.VQADataset(tasks, input_size=SIZE), fsm=fsm_t, **kw)
    assert json.dumps(got) == json.dumps(want)
    assert len(got) == 6
    if constrained:
        for r in got:
            assert JOINT_RE.fullmatch(r["answer"].strip()), r


def test_image_admission_matches_jax(models):
    """Image-conditioned requests without a prefix: each admission runs the
    towers and splices the image words (batch 1); three requests through
    two slots equal the JAX batcher's."""
    jm, tm = models
    rng = np.random.default_rng(4)
    images = [rng.normal(size=(SIZE, SIZE, 3)).astype(np.float32)
              for _ in range(3)]
    prompts = ["### Human: status of the door?", "detect parts",
               "the answer is"]
    jtok, ttok = _Recording(jm.tokenizer), _Recording(tm.tokenizer)
    jb = JBatcher(jm.params["llama"], jm.cfg.llama, jtok, slots=2,
                  ens5_params=jm.params, ens5_cfg=jm.cfg,
                  vocab_limit=jm.true_vocab)
    tb = ContinuousBatcher(tm.params["llama"], tm.args, ttok, slots=2,
                           ens5_params=tm.params, ens5_cfg=tm.cfg,
                           vocab_limit=tm.true_vocab, device="cpu")
    want = jb.generate(prompts, max_gen_len=[5, 7, 6], images=images)
    assert tb.generate(prompts, max_gen_len=[5, 7, 6],
                       images=images) == want
    assert ttok.decoded == jtok.decoded and tb.steps == jb.steps
    # the same requests against one image's cached prefix give what a full
    # admission with that image gives
    prefix = tb.make_prefix(image=images[0])
    assert prefix.length == 1 + tm.cfg.image_words
    full = tb.generate(prompts[1:], max_gen_len=6, images=[images[0]] * 2)
    assert tb.generate(prompts[1:], max_gen_len=6,
                       prefixes=[prefix] * 2) == full


@pytest.fixture
def float32_loads(tiny_towers, monkeypatch):
    """Both packages' ``from_pretrained`` load in float32, so the two CLIs
    can be held byte for byte."""
    for cls, dtype in ((JMetaModel, jnp.float32), (MetaModel, torch.float32)):
        real = cls.from_pretrained.__func__
        monkeypatch.setattr(cls, "from_pretrained", classmethod(
            lambda c, *a, _real=real, _dtype=dtype, **kw: _real(
                c, *a, **{**kw, "dtype": _dtype})))


@pytest.mark.parametrize("extra", [[], ["--constrained"],
                                   ["--draft_k", "2", "--kv_cache_bits", "8"]],
                         ids=["free", "grammar", "draft2_kv8"])
def test_main_continuous_batching_matches_jax(float32_loads, ckpt, tasks,
                                              tmp_path, extra):
    """Both CLIs with ``--continuous_batching`` on the same checkpoint:
    the results files are byte-identical."""
    argv = ["--pretrained_path", str(ckpt), "--dataset", tasks,
            "--batch_size", "2", "--max_gen_len", "12", "--max_seq_len",
            str(MAX_SEQ), "--temperature", "0", "--input_size", str(SIZE),
            "--continuous_batching"] + extra
    want = jeval.main(argv + ["--output_dir", str(tmp_path / "j")])
    got = teval.main(argv + ["--output_dir", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert Path(got).read_bytes() == Path(want).read_bytes()
    assert len(json.loads(Path(got).read_text())) == 6


def test_cli_refusals(tiny_towers, ckpt, tasks, tmp_path):
    """``--draft_k`` with a temperature is refused by both CLIs as a usage
    error; ``--continuous_batching`` with several devices by the port
    before loading (``ValueError``; the JAX CLI's assert fails after it)."""
    argv = ["--pretrained_path", str(ckpt), "--dataset", tasks,
            "--output_dir", str(tmp_path), "--continuous_batching",
            "--draft_k", "2", "--temperature", "0.5", "--max_seq_len",
            str(MAX_SEQ)]
    for main, more in ((jeval.main, []), (teval.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit) as err:
            main(argv + more)
        assert err.value.code == 2
    with pytest.raises(ValueError, match="--model_parallel_size > 1"):
        teval.main(["--dataset", tasks, "--tiny_random_model", "--device",
                    "cpu", "--continuous_batching", "--model_parallel_size",
                    "2"])
