"""The port's eval CLI at ``--model_parallel_size 2`` against the JAX
CLI's, on the checkpoint of tests/test_torch_eval.py (its fixtures,
imported): the weights split over two gloo ranks through
``ModelServer(meta_model=...)``, dense and ``--quant`` (the all-column form
of ``tp_align``); both loads held to float32.

Tolerance: the results files byte for byte."""

from pathlib import Path

import pytest
import torch
from test_torch_eval import (  # noqa: F401 (fixtures)
    MAX_SEQ,
    SIZE,
    ckpt,
    tasks,
    tiny_towers,
)
from test_torch_serving_eval import float32_loads  # noqa: F401 (fixture)

from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu_torch import eval_affordance as teval

torch.set_num_threads(1)


@pytest.mark.parametrize("extra", [[], ["--quant"]], ids=["dense", "int4"])
def test_main_model_parallel_matches_jax(float32_loads, ckpt, tasks,
                                         tmp_path, extra):
    """Both CLIs at ``--model_parallel_size 2`` on the same checkpoint: the
    results files are byte-identical."""
    argv = ["--pretrained_path", str(ckpt), "--dataset", tasks,
            "--batch_size", "2", "--max_gen_len", "12", "--max_seq_len",
            str(MAX_SEQ), "--temperature", "0", "--input_size", str(SIZE),
            "--model_parallel_size", "2"] + extra
    want = jeval.main(argv + ["--output_dir", str(tmp_path / "j")])
    got = teval.main(argv + ["--output_dir", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert Path(got).read_bytes() == Path(want).read_bytes()
    assert not torch.distributed.is_initialized()  # the ranks stopped
