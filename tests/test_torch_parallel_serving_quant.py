"""The port's ``ModelServer(pretrained_path=..., quant=True,
model_parallel_size=2)`` against the JAX package's on the tiny llama_ens5
checkpoint of tests/test_torch_eval.py (its fixtures, imported): the
chunk-packed row-parallel int4 tree, held through ``run_eval``; and the
ranks' lifetime (a failed call and ``close()`` stop them; a closed server
refuses calls; one sharded server a process; too few devices refused).

Tolerance: float32 on both sides; the results JSON byte for byte."""

import json

import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_eval import (  # noqa: F401 (fixtures)
    MAX_SEQ,
    SIZE,
    ckpt,
    tasks,
    tiny_towers,
)
from test_torch_parallel_serving import CPU2, PROMPTS
from test_torch_serving_eval import float32_loads  # noqa: F401 (fixture)

from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu.serving import ModelServer as JServer
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch.serving import ModelServer

torch.set_num_threads(1)


def test_from_pretrained_quant_server_matches_jax(float32_loads, ckpt,
                                                  tasks):
    """``quant=True`` at mp 2 quantizes with ``tp_align`` 256 and
    ``row_parallel`` 2 (w2 chunk-packed, each rank a chunk); the task file
    through ``run_eval`` gives the JAX server's results JSON."""
    kw = dict(pretrained_path=str(ckpt), max_seq_len=MAX_SEQ, quant=True,
              model_parallel_size=2)
    js = JServer(**kw)
    ts = ModelServer(**kw, devices=CPU2)
    try:
        w2 = js.model.params["llama"]["layers"]["feed_forward"]["w2"][
            "weight"]
        assert w2.k_chunks == 2
        run = dict(batch_size=2, max_gen_len=16, temperature=0.0)
        want = jeval.run_eval(js, jeval.VQADataset(tasks, input_size=SIZE),
                              **run)
        got = teval.run_eval(ts, teval.VQADataset(tasks, input_size=SIZE),
                             **run)
        assert json.dumps(got) == json.dumps(want) and len(got) == 6
        assert [s["wq_columns"] for s in ts.map_ranks(ranks.rank_state)] \
            == [64, 64]  # wq's 64 columns do not split in 2 x 128: whole
    finally:
        ts.close()


def test_server_stops_its_ranks_on_close_and_on_failure(ckpt,
                                                        float32_loads):
    ts = ModelServer(pretrained_path=str(ckpt), max_seq_len=MAX_SEQ,
                     model_parallel_size=2, devices=CPU2)
    procs = list(ts._ranks.procs)
    with pytest.raises(ValueError, match="one sharded server"):
        ModelServer(pretrained_path=str(ckpt), max_seq_len=MAX_SEQ,
                    model_parallel_size=2, devices=CPU2)
    with pytest.raises(ValueError, match="batched LIST"):
        ts.generate("not a list")  # fails on every rank
    assert ts._ranks is None and not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        ts.generate(PROMPTS)
    ts2 = ModelServer(pretrained_path=str(ckpt), max_seq_len=MAX_SEQ,
                      model_parallel_size=2, devices=CPU2)
    procs = list(ts2._ranks.procs)
    ts2.close()
    assert not any(p.is_alive() for p in procs)


def test_server_refuses_fewer_devices_than_the_mesh(ckpt):
    """The rewritten refusal: model_parallel_size 2 no longer raises for
    being unported, but for want of devices (no card here; one named)."""
    for devices in (None, ["cpu"]):
        with pytest.raises(ValueError, match="needs as many devices"):
            ModelServer(pretrained_path=str(ckpt), model_parallel_size=2,
                        devices=devices)
    with pytest.raises(ValueError, match="not divisible"):
        ModelServer(pretrained_path=str(ckpt), model_parallel_size=2,
                    devices=["cpu"] * 3)
