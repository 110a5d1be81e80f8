"""The port's training CLI on several ranks, on the CPU: ``main_finetune``
at ``--model_parallel_size 2 --devices cpu,cpu`` and at ``--num_devices 2
--device cpu`` (data 2, the towers' features cached and spilled, a
directory a rank) against the same CLI on one device, the same
global batch, the tiny random llama_ens5 with rank-4 adapters over a dense
base (its widths are the same on one device and on two ranks; the int4
base packed for a mesh is held against JAX by
tests/test_torch_parallel_train*.py), float32, accumulation 2, remat; then
the model-2 run's first checkpoint resumed on one device.

Tolerances: each update's loss and grad norm to a relative 1e-5 and the
trained leaves to 1e-5 absolute (tests/test_torch_train.py's)."""

import json
import shutil

import numpy as np
import pytest
import torch
from test_torch_train import _assert_trees_close, _write_dialog_data

from a3vlm_tpu_torch import main_finetune
from a3vlm_tpu_torch.checkpoint.bridge import params_to_numpy
from a3vlm_tpu_torch.parallel import tp

torch.set_num_threads(1)


def _argv(tokenizer_dir, data, out):
    return ["--tokenizer_path", tokenizer_dir, "--data_config", str(data),
            "--dialog", "--tiny_random_model", "--lora_rank", "4",
            "--only_save_trainable", "--checkpointing", "--accum_iter", "2",
            "--epochs", "2", "--warmup_epochs", "0", "--lr", "1e-3",
            "--min_lr", "1e-3", "--max_words", "256", "--precision",
            "fp32", "--device", "cpu", "--print_freq", "1",
            "--output_dir", str(out)]


@pytest.fixture(scope="module")
def runs(tiny_tokenizer_dir, tmp_path_factory):
    """One device at batch 4; model 2 at batch 4; data 2 at batch 2 a
    rank, the tower features cached: the same global batch."""
    root = tmp_path_factory.mktemp("cli")
    data = _write_dialog_data(root)
    out = {}
    for name, extra in (
            ("one", ["--batch_size", "4"]),
            ("model2", ["--batch_size", "4", "--model_parallel_size", "2",
                        "--devices", "cpu,cpu", "--data_parallel", "fsdp"]),
            ("data2", ["--batch_size", "2", "--num_devices", "2",
                       "--cache_tower_features", "--feature_cache_dir",
                       str(root / "features")])):
        state, reports = main_finetune.train(
            _argv(tiny_tokenizer_dir, data, root / name) + extra)
        out[name] = {"state": state, "reports": reports,
                     "dir": root / name}
    out["data"], out["root"] = data, root
    return out


@pytest.mark.parametrize("mesh", ["model2", "data2"])
def test_cli_on_two_ranks_matches_one_device(runs, mesh):
    """Every update's loss and grad norm as on one device; the trained
    adapters and projectors (a split adapter: rank 0's block of the
    one-device leaf) too; every rank's replicated trainables the same
    bytes."""
    got, want = runs[mesh], runs["one"]
    steps = [(s["loss"], s["grad_norm"]) for s in got["reports"][0]["steps"]]
    ref = [(s["loss"], s["grad_norm"]) for s in want["reports"][0]["steps"]]
    assert len(steps) == len(ref) == 2
    np.testing.assert_allclose(np.asarray(steps), np.asarray(ref),
                               rtol=1e-5)
    assert len(got["reports"]) == 2
    assert len({r["replicas"] for r in got["reports"]}) == 1
    losses = [[(s["loss"], s["grad_norm"]) for s in r["steps"]]
              for r in got["reports"]]
    assert losses[1] == losses[0]
    one = want["state"].params
    two = got["state"].params
    for group, name in (("attention", "wq"), ("feed_forward", "w2")):
        for k in ("a", "b"):
            a = two["lora"]["layers"][1][group][name][k]
            b = one["lora"]["layers"][1][group][name][k]
            if isinstance(a, tp.Shard):  # rank 0's block
                b = a.take(b)
                a = a.local
            torch.testing.assert_close(a, b, atol=1e-5, rtol=0)
    torch.testing.assert_close(two["visual_proj"]["linear"]["weight"],
                               one["visual_proj"]["linear"]["weight"],
                               atol=1e-5, rtol=0)


def _stored(path):
    return params_to_numpy(torch.load(path, weights_only=True))


def test_cli_model2_checkpoints_equal_one_device(runs):
    """The model-2 run writes the one-device run's checkpoints (rank 0
    writes the gathered leaves; the log is rank 0's alone), the tensors
    within the training tolerance."""
    for name in ("epoch_0", "epoch_1"):
        for run in ("one", "model2", "data2"):
            assert (runs[run]["dir"] / name / "_DONE").exists()
        got = _stored(runs["model2"]["dir"] / name / "model.pt")
        want = _stored(runs["one"]["dir"] / name / "model.pt")
        _assert_trees_close(got, want, atol=1e-5)
    log = (runs["model2"]["dir"] / "log.txt").read_text().splitlines()
    assert len(log) == 2 and json.loads(log[1])["epoch"] == 1
    # data 2's caches: one directory a rank, every item's features in each
    for r in (0, 1):
        assert len(list((runs["root"] / "features" / f"rank_{r}").glob(
            "*.npz"))) == 8


def test_cli_model2_checkpoint_resumes_on_one_device(runs,
                                                      tiny_tokenizer_dir):
    """The model-2 run's epoch_0, resumed on one device (``--resume
    auto``), gives epoch 1 as the model-2 run took it."""
    root = runs["root"] / "resumed"
    root.mkdir()
    shutil.copytree(runs["model2"]["dir"] / "epoch_0", root / "epoch_0")
    state, reports = main_finetune.train(
        _argv(tiny_tokenizer_dir, runs["data"], root)
        + ["--batch_size", "4", "--resume", "auto"])
    steps = reports[0]["steps"]
    assert len(steps) == 1
    want = runs["model2"]["reports"][0]["steps"][1]
    np.testing.assert_allclose([steps[0]["loss"], steps[0]["grad_norm"]],
                               [want["loss"], want["grad_norm"]], rtol=1e-5)
    _assert_trees_close(_stored(root / "epoch_1" / "model.pt"),
                        _stored(runs["model2"]["dir"] / "epoch_1"
                                / "model.pt"), atol=1e-5)
