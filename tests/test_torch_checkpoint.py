"""The port's fine-tuning loop against the JAX package: the checkpoint
manager (round trip, latest-checkpoint discovery, asynchronous saves), the
training CLI's saves and two-stage ``--resume``, the LoRA fold, adapter
loading (``load_adapter_checkpoint``, ``eval_affordance --adapter_path``)
and the export tools, on the tiny llama_ens5 checkpoint of
``test_torch_eval.py``.

Neither package reads the other's checkpoint files (Orbax directories, or
``torch.save`` files), so a checkpoint the JAX CLI wrote is turned into
the port's format here through numpy, and the two are held to the same
paths, shapes, dtypes and sidecars.

Tolerances: the port's resumed runs against its uninterrupted ones bit for
bit (float32 on the CPU, one thread: the same operations in the same
order); the port against JAX in float32, losses and logits to 1e-4 (the
summation order differs), the merged weights and the exported tensors to
1e-6 (a rank-4 product W + A @ B in float32); what is only moved or
renamed exactly."""

import json
import shutil
import threading
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_eval import (  # noqa: F401 (fixtures)
    ATOL,
    MAX_SEQ,
    SIZE,
    ckpt,
    tasks,
    tiny_towers,
)

from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu import main_finetune as jfinetune
from a3vlm_tpu.checkpoint import manager as jmanager
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.tools import convert_weights_to_hf as jhf
from a3vlm_tpu.tools import merge_lora as jmerge
from a3vlm_tpu.tools import weight_operate as jweights
from a3vlm_tpu.train import lora as jlora
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch import main_finetune as tfinetune
from a3vlm_tpu_torch.checkpoint import manager as tmanager
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.quant import _quantize_leaf_int4
from a3vlm_tpu_torch.tools import convert_weights_to_hf as thf
from a3vlm_tpu_torch.tools import merge_lora as tmerge
from a3vlm_tpu_torch.tools import weight_operate as tweights
from a3vlm_tpu_torch.train import lora as tlora
from a3vlm_tpu_torch.train.step import AdamW, TrainState, tree_leaves

torch.set_num_threads(1)


# -- the manager alone ------------------------------------------------------

def _small_tree(seed=0):
    """A tree with the port's shapes of layout: a per-layer decoder list
    (one bf16 leaf), a conv kernel (OIHW), adapters, a top-level tag."""
    g = torch.Generator().manual_seed(seed)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    return {
        "llama": {"layers": [{"attention_norm": {"weight": r(4).bfloat16()},
                              "attention": {"wq": {"weight": r(4, 4)}}}
                             for _ in range(3)],
                  "norm": {"weight": r(4)}},
        "clip": {"patch_embed": {"kernel": r(8, 3, 2, 2)}},
        "start_img": r(1, 1, 4),
        "lora": {"layers": [{"attention": {"wq": {"a": r(4, 2),
                                                  "b": r(2, 4)}}}
                            for _ in range(3)]},
    }


def _small_mask():
    return {
        "llama": {"layers": [{"attention_norm": {"weight": True},
                              "attention": {"wq": {"weight": False}}}
                             for _ in range(3)],
                  "norm": {"weight": True}},
        "clip": {"patch_embed": {"kernel": False}},
        "start_img": True,
        "lora": {"layers": [{"attention": {"wq": {"a": True, "b": True}}}
                            for _ in range(3)]},
    }


def _loss(params, batch):
    x = batch["x"]
    for lp, ab in zip(params["llama"]["layers"], params["lora"]["layers"]):
        w = lp["attention"]["wq"]["weight"]
        a, b = ab["attention"]["wq"]["a"], ab["attention"]["wq"]["b"]
        x = torch.tanh(x @ w + (x @ a) @ b) * lp["attention_norm"][
            "weight"].float()
    return ((x * params["llama"]["norm"]["weight"]).sum()
            + params["start_img"].sum()) ** 2


def _train_state(seed=0):
    from a3vlm_tpu_torch.train.step import make_train_step

    mask = _small_mask()
    opt = AdamW(1e-2)
    state = TrainState.create(_small_tree(seed), opt, mask)
    step = make_train_step(_loss, opt, trainable_mask=mask)
    return state, step, mask


def _trainables(state, mask):
    from a3vlm_tpu_torch.train.step import partition_params

    return (tree_leaves(partition_params(state.params, mask)[0])
            + tree_leaves(state.opt_state.mu) + tree_leaves(state.opt_state.nu))


def test_manager_round_trip(tmp_path):
    """The stored tree is the JAX layout (layers stacked, kernels HWIO),
    every dtype kept (bf16 stays bf16), frozen leaves ``None`` holes; the
    restore merges the holes from the live tree and gives back each
    stored leaf bit for bit, the counters and every sidecar."""
    state, step, mask = _train_state()
    state, _ = step(state, {"x": torch.ones(2, 4)})
    mgr = tmanager.CheckpointManager(str(tmp_path))
    path = mgr.save(1, None, params=state.params, opt_state=state.opt_state,
                    step=state.step, dataset_state={"epoch": 1},
                    llama_type="llama_ens5",
                    llama_config={"max_seq_len": 64}, trainable_mask=mask,
                    extra={"note": "x"})
    d = Path(path)
    assert d.name == "epoch_1" and (d / "_DONE").exists()
    assert json.loads((d / "other.json").read_text()) == {
        "epoch": 1, "iter": 0, "step": 1, "note": "x"}
    assert json.loads((d / "dataset_state.json").read_text()) == {"epoch": 1}
    assert json.loads((d / "meta.json").read_text()) == {
        "llama_type": "llama_ens5"}
    assert json.loads((d / "config.json").read_text()) == {"max_seq_len": 64}

    raw = tmanager.restore_raw_checkpoint(path)
    norm = raw["llama"]["layers"]["attention_norm"]["weight"]
    assert norm.shape == (3, 4) and norm.dtype == torch.bfloat16
    assert raw["llama"]["layers"]["attention"]["wq"]["weight"] is None
    assert raw["clip"]["patch_embed"]["kernel"] is None
    assert raw["lora"]["layers"]["attention"]["wq"]["a"].shape == (3, 4, 2)
    for i, lp in enumerate(state.params["llama"]["layers"]):
        assert torch.equal(norm[i], lp["attention_norm"]["weight"])

    live = _small_tree(seed=1)  # other values everywhere
    restored = mgr.restore_params(path, live)
    assert restored["clip"]["patch_embed"]["kernel"] is \
        live["clip"]["patch_embed"]["kernel"]
    assert restored["llama"]["layers"][2]["attention"]["wq"]["weight"] is \
        live["llama"]["layers"][2]["attention"]["wq"]["weight"]
    extra = mgr.restore_train_state(path, TrainState.create(
        live, AdamW(1e-2), mask).opt_state)
    got = _trainables(TrainState(restored, extra["opt_state"], 0), mask)
    want = _trainables(state, mask)
    assert len(got) == len(want) == 3 * 11  # params, mu, nu
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert extra["opt_state"].count == 1
    assert (extra["epoch"], extra["iter"], extra["step"]) == (1, 0, 1)
    assert extra["dataset_state"] == {"epoch": 1}

    # a whole tree with a conv kernel: HWIO on disk, OIHW back
    full = mgr.save(2, params=_small_tree(seed=2))
    k = tmanager.restore_raw_checkpoint(full)["clip"]["patch_embed"]["kernel"]
    assert k.shape == (2, 2, 3, 8)
    back = mgr.restore_params(full, live)["clip"]["patch_embed"]["kernel"]
    assert torch.equal(back, _small_tree(seed=2)["clip"]["patch_embed"][
        "kernel"])
    # a packed base is frozen: it is not stored
    packed = {"w": _quantize_leaf_int4(torch.randn(64, 8))}
    with pytest.raises(ValueError, match="trainable_mask"):
        mgr.save(3, params=packed)


@pytest.mark.parametrize("names,done", [
    (["epoch_0", "epoch_0-iter_5", "epoch_1-iter_3"], None),
    (["epoch_2-iter_10", "epoch_2", "epoch_1"], None),
    (["epoch_2", "epoch_3-iter_1"], ["epoch_2"]),
    (["epoch_10", "epoch_9-iter_99", "epoch_9"], None),
    (["epoch_1-iter_2", "epoch_1-iter_10"], None),
    (["foo", "epoch_x", "epoch_1-iter_"], None),
    (["epoch_4"], []),
    ([], None),
], ids=["iter-of-later-epoch", "full-epoch-wins", "no-done-skipped",
        "numeric-order", "iter-order", "other-names", "none-done", "empty"])
def test_find_latest_checkpoint_matches_jax(tmp_path, names, done):
    for n in names:
        (tmp_path / n).mkdir()
        if done is None or n in done:
            (tmp_path / n / "_DONE").touch()
    got = tmanager.find_latest_checkpoint(str(tmp_path))
    assert got == jmanager.find_latest_checkpoint(str(tmp_path))
    assert tmanager.find_latest_checkpoint(str(tmp_path / "absent")) is None


def test_async_save_writes_the_pre_step_values(tmp_path, monkeypatch):
    """``wait=False``: ``_DONE`` only after the barrier, and a step taken
    at once after ``save`` (the optimizer updates in place) leaves the
    written values those of before the step. Each write is held back
    until its step has run; five saves in a row."""
    gate = threading.Event()
    real_save = torch.save

    def gated_save(obj, path):
        assert gate.wait(timeout=30)
        real_save(obj, path)

    monkeypatch.setattr(tmanager.torch, "save", gated_save)
    state, step, mask = _train_state()
    mgr = tmanager.CheckpointManager(str(tmp_path))
    batch = {"x": torch.ones(2, 4)}
    for i in range(5):
        gate.clear()
        before = [t.clone() for t in _trainables(state, mask)]
        path = mgr.save(0, i + 1, params=state.params,
                        opt_state=state.opt_state, step=state.step,
                        trainable_mask=mask, wait=False)
        assert not (Path(path) / "_DONE").exists()
        assert tmanager.find_latest_checkpoint(str(tmp_path)) != path
        state, _ = step(state, batch)
        assert not torch.equal(_trainables(state, mask)[0], before[0])
        gate.set()
        mgr.wait_until_finished()
        assert (Path(path) / "_DONE").exists()
        assert tmanager.find_latest_checkpoint(str(tmp_path)) == path
        restored = TrainState(
            mgr.restore_params(path, state.params),
            mgr.restore_train_state(path, state.opt_state)["opt_state"], 0)
        for a, b in zip(_trainables(restored, mask), before):
            assert torch.equal(a, b)
        assert mgr.last_write_seconds >= 0


def test_async_save_error_surfaces_at_the_barrier(tmp_path, monkeypatch):
    def failing_save(obj, path):
        raise OSError("disk full")

    monkeypatch.setattr(tmanager.torch, "save", failing_save)
    mgr = tmanager.CheckpointManager(str(tmp_path))
    path = mgr.save(0, 1, params={"w": torch.ones(2)}, wait=False)
    with pytest.raises(RuntimeError, match="failed"):
        mgr.wait_until_finished()
    assert not (Path(path) / "_DONE").exists()


# -- the training CLI ----------------------------------------------------------

def _dialog_data(d: Path, n: int) -> str:
    """n items of one text (one token length, so accumulation can stack
    them) over n images of their own, which make the order visible."""
    for i in range(n):
        Image.fromarray(np.random.default_rng(i).integers(
            0, 255, (48, 64, 3)).astype(np.uint8)).save(d / f"img{i}.png")
    (d / f"tasks{n}.json").write_text(json.dumps([
        {"image": str(d / f"img{i}.png"), "conversations": [
            {"from": "human", "value": "Where is door 0?"},
            {"from": "gpt", "value": "door 0 here"}]} for i in range(n)]))
    cfg = d / f"data{n}.yaml"
    cfg.write_text(f"META:\n - path: {d / f'tasks{n}.json'}\n"
                   "   type: image_text\n")
    return str(cfg)


def _argv(ckpt, data, extra=()):
    return ["--tokenizer_path", str(ckpt), "--data_config", data, "--dialog",
            "--pretrained_path", str(ckpt), "--quant", "--lora_rank", "4",
            "--only_save_trainable", "--batch_size", "2", "--lr", "1e-3",
            "--warmup_epochs", "0.5", "--max_words", "128", "--precision",
            "fp32", "--save_iteration_interval", "1", "--print_freq", "100",
            *extra]


def _ckpt_dirs(d: Path) -> list:
    return sorted(p.name for p in d.iterdir() if p.name.startswith("epoch"))


def _log(d: Path) -> list:
    return [json.loads(x) for x in (d / "log.txt").read_text().splitlines()]


@pytest.fixture(scope="module")
def port_runs(tiny_towers, ckpt, tmp_path_factory):
    """Accumulation 1, 2 epochs of 2 updates: the port's CLI
    uninterrupted, and resumed from the end of epoch 0 and from the middle
    of it (each into an output directory of its own, ``--resume DIR``)."""
    root = tmp_path_factory.mktemp("port_runs")
    argv = _argv(ckpt, _dialog_data(root, 4), ["--epochs", "2",
                                               "--device", "cpu"])
    runs = {"full": tfinetune.main(argv + ["--output_dir",
                                           str(root / "full")])}
    for name, frm in (("end", "epoch_0"), ("mid", "epoch_0-iter_1")):
        runs[name] = tfinetune.main(argv + [
            "--output_dir", str(root / name), "--resume",
            str(root / "full" / frm)])
    return root, runs


@pytest.mark.parametrize("resumed", ["end", "mid"])
def test_resumed_cli_run_is_bit_for_bit(port_runs, resumed):
    """4 updates against 2 + ``--resume`` + 2 (and 1 + 3 from the
    in-epoch save): the final parameters, both moments and the count,
    the epoch-1 checkpoint files and epoch 1's log line are the same."""
    root, runs = port_runs
    full, res = runs["full"], runs[resumed]
    a = tree_leaves(full.params["lora"]) + tree_leaves(full.opt_state.mu) + \
        tree_leaves(full.opt_state.nu)
    b = tree_leaves(res.params["lora"]) + tree_leaves(res.opt_state.mu) + \
        tree_leaves(res.opt_state.nu)
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))
    for key in ("visual_proj", "start_img"):
        for x, y in zip(tree_leaves(full.params[key]),
                        tree_leaves(res.params[key])):
            assert torch.equal(x, y)
    assert full.opt_state.count == res.opt_state.count == 4
    for f in ("model.pt", "optimizer.pt"):
        x = torch.load(root / "full" / "epoch_1" / f, weights_only=True)
        y = torch.load(root / resumed / "epoch_1" / f, weights_only=True)
        assert _flat(x).keys() == _flat(y).keys()
        for k, v in _flat(x).items():
            assert torch.equal(v, _flat(y)[k]), k
    assert _log(root / resumed)[-1] == _log(root / "full")[1]
    # the JAX CLI's step counter is not restored: a resumed run counts
    # from 0 (other.json), while the optimizer's count goes on
    assert json.loads((root / resumed / "epoch_1" / "other.json")
                      .read_text())["step"] == res.step < full.step == 4


def _flat(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}/{i}"))
    elif tree is not None and not isinstance(tree, (int, float)):
        out[prefix] = tree
    return out


@pytest.fixture(scope="module")
def jax_vs_port(tiny_towers, ckpt, tmp_path_factory):
    """Accumulation 2, 12 items: 3 updates an epoch. Each CLI
    uninterrupted, then resumed from its ``epoch_0-iter_2`` into a
    directory of its own, in float32, the port's adapters made as the JAX
    CLI makes them."""
    root = tmp_path_factory.mktemp("jax_vs_port")
    argv = _argv(ckpt, _dialog_data(root, 12), ["--epochs", "1",
                                                "--accum_iter", "2"])
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tfinetune, "init_lora_params", _jax_lora_init)
        for pkg, main, more in (("j", jfinetune.main, ["--num_devices", "1"]),
                                ("t", tfinetune.main, ["--device", "cpu"])):
            main(argv + more + ["--output_dir", str(root / pkg / "full")])
            main(argv + more + ["--output_dir", str(root / pkg / "resumed"),
                                "--resume",
                                str(root / pkg / "full" / "epoch_0-iter_2")])
    return root


def _jax_lora_init(generator, llama, rank):
    """The adapters the JAX CLI makes (``init_lora_params`` from
    ``PRNGKey(seed + 17)``, seed 0) in the port's layout, so both CLIs
    start from the same A."""
    L = len(llama["layers"])
    shapes = {"layers": {group: {
        name: {"weight": np.zeros((L, *tlora._weight_geometry(wp["weight"])),
                                  np.float32)}
        for name, wp in llama["layers"][0][group].items()}
        for group in tlora.GROUPS}}
    lora = jlora.init_lora_params(jax.random.PRNGKey(17), shapes, rank=rank)
    return params_from_numpy({"lora": jax.tree_util.tree_map(np.asarray,
                                                             lora)},
                             device="cpu")["lora"]


@pytest.mark.parametrize("run", ["full", "resumed"])
def test_cli_checkpoints_match_jax(jax_vs_port, run):
    """The same checkpoint directories, each with ``_DONE``, the same
    ``other.json``, ``dataset_state.json``, ``meta.json`` and
    ``config.json``, and the same log to 1e-4. Resumed from
    ``epoch_0-iter_2``: the loader's length stays 3 and ``it`` counts from
    0, so the next in-epoch save is ``epoch_0-iter_1``; the sampler skips
    2 x batch size samples, not 2 x batch x accumulation, so two updates
    follow, not one (data replayed)."""
    j, t = jax_vs_port / "j" / run, jax_vs_port / "t" / run
    names = _ckpt_dirs(j)
    assert _ckpt_dirs(t) == names
    assert names == ["epoch_0", "epoch_0-iter_1", "epoch_0-iter_2"]
    for n in names:
        assert (t / n / "_DONE").exists()
        for f in ("other.json", "dataset_state.json", "meta.json",
                  "config.json"):
            assert json.loads((t / n / f).read_text()) == json.loads(
                (j / n / f).read_text()), (n, f)
    got, want = _log(t), _log(j)
    assert len(got) == len(want) == 1
    # the mean loss and learning rate (the mean gradient norm is not held
    # here: test_torch_train holds each gradient leaf)
    for k in ("closs", "lr"):
        assert abs(got[0][k] - want[0][k]) < ATOL, k
    count = torch.load(t / "epoch_0" / "optimizer.pt",
                       weights_only=True)["count"]
    assert count == (3 if run == "full" else 2 + 2)
    if run == "resumed":  # the first save after resuming from iter_2
        assert json.loads((t / "epoch_0-iter_1" / "dataset_state.json")
                          .read_text()) == {"epoch": 0, "start_iter": 1}
        assert torch.load(t / "epoch_0-iter_1" / "optimizer.pt",
                          weights_only=True)["count"] == 3
    assert json.loads((t / "epoch_0" / "other.json").read_text())[
        "step"] == (3 if run == "full" else 2)


def _jax_raw(path):
    """A JAX checkpoint's model tree with the holes of packed bases (one
    ``None`` per field) as one ``None``, as numpy."""
    raw = jmanager.restore_raw_checkpoint(str(path))

    def norm(x):
        if isinstance(x, dict):
            return {k: norm(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            if all(v is None for v in x):
                return None
            return [norm(v) for v in x]
        return None if x is None else np.asarray(x)

    return norm(raw)


def test_cli_checkpoint_tree_matches_jax(jax_vs_port):
    """Paths, shapes and dtypes of the model and optimizer trees of the
    port's checkpoint are the JAX CLI's (layers stacked, adapters
    [L, in, r] / [L, r, out], frozen leaves holes)."""
    import orbax.checkpoint as ocp

    j = jax_vs_port / "j" / "full" / "epoch_0"
    t = jax_vs_port / "t" / "full" / "epoch_0"

    def layout(tree):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in _flat(tree).items()}

    want = layout(_jax_raw(j))
    got = layout(tmanager.restore_raw_checkpoint(str(t)))
    assert got == want
    assert "/lora/layers/feed_forward/w2/a" in got
    holes = {k for k, v in _flat_holes(_jax_raw(j)).items()}
    assert holes == set(_flat_holes(tmanager.restore_raw_checkpoint(str(t))))
    jopt = ocp.PyTreeCheckpointer().restore(str((j / "optimizer").absolute()))
    adam = jopt[1][0]
    topt = torch.load(t / "optimizer.pt", weights_only=True)
    for m in ("mu", "nu"):
        assert layout(topt[m]) == layout(jax.tree_util.tree_map(
            np.asarray, adam[m]))
    assert topt["count"] == int(adam["count"]) == 3


def _flat_holes(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flat_holes(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flat_holes(v, f"{prefix}/{i}"))
    elif tree is None:
        out[prefix] = None
    return out


# -- the LoRA fold ---------------------------------------------------------------

def test_fit_and_merge_lora_match_jax():
    """Adapters wider than the base (trained against a padded base) are
    sliced to it and folded as W + A @ B, in float32 as the JAX
    functions do; a packed base refuses the fold."""
    rng = np.random.default_rng(4)
    L, D, F_, r = 2, 16, 24, 4
    decoder = {"layers": {
        "attention": {w: {"weight": rng.normal(size=(L, D, D)).astype(
            np.float32)} for w in ("wq", "wk", "wv", "wo")},
        "feed_forward": {
            "w1": {"weight": rng.normal(size=(L, D, F_)).astype(np.float32)},
            "w2": {"weight": rng.normal(size=(L, F_, D)).astype(np.float32)},
            "w3": {"weight": rng.normal(size=(L, D, F_)).astype(np.float32)}},
        "attention_norm": {"weight": np.ones((L, D), np.float32)},
        "ffn_norm": {"weight": np.ones((L, D), np.float32)}},
        "norm": {"weight": np.ones(D, np.float32)}}
    lora = {"layers": {}}
    for group, items in decoder["layers"].items():
        if group.endswith("norm"):
            continue
        for name, wp in items.items():
            _, i, o = wp["weight"].shape
            lora["layers"].setdefault(group, {})[name] = {
                "a": rng.normal(size=(L, i + 8, r)).astype(np.float32),
                "b": rng.normal(size=(L, r, o + 8)).astype(np.float32)}
    jfit = jlora.fit_lora_to(decoder, lora)
    want = jax.tree_util.tree_map(np.asarray, jlora.merge_lora(
        jax.tree_util.tree_map(jnp.asarray, decoder), jfit))
    tdec = params_from_numpy({"llama": decoder, "lora": lora},
                             device="cpu")
    tfit = tlora.fit_lora_to(tdec["llama"], tdec["lora"])
    assert tfit["layers"][1]["feed_forward"]["w2"]["a"].shape == (F_, r)
    got = tlora.merge_lora_into_model(tdec, tfit)["llama"]
    for group in ("attention", "feed_forward"):
        for name, wp in want["layers"][group].items():
            for i in range(L):
                np.testing.assert_allclose(
                    got["layers"][i][group][name]["weight"].numpy(),
                    wp["weight"][i], rtol=0, atol=1e-5,
                    err_msg=f"{group}/{name}/{i}")
    assert got["layers"][0]["attention_norm"]["weight"] is \
        tdec["llama"]["layers"][0]["attention_norm"]["weight"]
    packed = {"layers": [{"attention": {"wq": {"weight": _quantize_leaf_int4(
        torch.randn(D, D))}}}]}
    with pytest.raises(ValueError, match="dense base"):
        tlora.merge_lora(packed, {"layers": [{"attention": {"wq": {
            "a": torch.zeros(D, r), "b": torch.zeros(r, D)}}}]})


# -- adapters: loading, serving, the tools --------------------------------------

@pytest.fixture(scope="module")
def adapters(jax_vs_port, tmp_path_factory):
    """The JAX CLI's trained adapter checkpoint, and the same weights as
    a checkpoint of the port (JAX raw tree -> numpy -> the port's tree ->
    ``CheckpointManager.save``)."""
    jdir = jax_vs_port / "j" / "full" / "epoch_0"
    tree = params_from_numpy(_jax_raw(jdir), device="cpu")
    mgr = tmanager.CheckpointManager(str(tmp_path_factory.mktemp("conv")))
    tdir = mgr.save(0, params=tree)
    return jdir, Path(tdir)


@pytest.mark.parametrize("merge", [False, True], ids=["unmerged", "merged"])
def test_load_adapter_checkpoint_matches_jax(tiny_towers, ckpt, adapters,
                                             merge):
    """The same trained weights, each package's checkpoint format:
    logits to 1e-4 and the same greedy ids; unmerged on the int4 base
    (the JAX Generator cannot decode through unmerged adapters, so the
    port's first greedy id is held to the JAX logits' argmax), merged on
    the dense base (greedy decoding in both)."""
    jdir, tdir = adapters
    jm = JMetaModel.from_pretrained(str(ckpt), with_visual=True,
                                    max_seq_len=MAX_SEQ, dtype=jnp.float32)
    tm = MetaModel.from_pretrained(str(ckpt), with_visual=True,
                                   max_seq_len=MAX_SEQ, dtype=torch.float32,
                                   device="cpu")
    if not merge:
        jm.quantize(bits=4)
        tm.quantize(bits=4)
    plain = tm.compute_logits(["hello door"])[0]
    jm.load_adapter_checkpoint(str(jdir), merge=merge)
    tm.load_adapter_checkpoint(str(tdir), merge=merge)
    assert tm.params["visual_proj"]["linear"]["weight"].dtype == torch.float32
    texts = ["hello door", "open the drawer please"]
    images = np.random.default_rng(1).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    got = tm.compute_logits(texts, images=images)
    for a, b in zip(got, jm.compute_logits(texts, images=images)):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    assert np.abs(tm.compute_logits(["hello door"])[0] - plain).max() > 1e-3
    if merge:
        want = jm.generate(texts, images=images, max_gen_len=8,
                           temperature=0.0)
        assert tm.generate(texts, images=images, max_gen_len=8,
                           temperature=0.0) == want
    else:
        prompt = tm.tokenizer.encode(texts[1], bos=True, eos=False)
        first = tm.generate_tokens([prompt], max_gen_len=1,
                                   stop_tokens=())[0][0]
        assert first == int(jm.compute_logits(texts)[1][-1].argmax())


@pytest.fixture(scope="module")
def merged_ckpts(tiny_towers, ckpt, adapters, tmp_path_factory):
    """``tools.merge_lora`` of each package on the same base and adapter
    weights (float32), each beside the base's config.json."""
    jdir, tdir = adapters
    root = tmp_path_factory.mktemp("merged")
    jmerge.main(["--base", str(ckpt), "--adapter", str(jdir),
                 "--output_dir", str(root / "j")])
    tmerge.main(["--base", str(ckpt), "--adapter", str(tdir),
                 "--output_dir", str(root / "t"), "--device", "cpu"])
    for d in ("j", "t"):
        shutil.copy(ckpt / "config.json", root / d / "config.json")
    return root


def _consolidated(d: Path) -> dict:
    files = sorted(d.glob("consolidated.*.pth"))
    assert len(files) == 1
    return torch.load(files[0], weights_only=True)["model"]


def test_merge_lora_tool_matches_jax(merged_ckpts):
    """The merged consolidated files hold the same tensors: the folded
    linears to 1e-6, everything else exactly; the same sidecars."""
    j, t = merged_ckpts / "j", merged_ckpts / "t"
    want, got = _consolidated(j), _consolidated(t)
    assert got.keys() == want.keys()
    folded = 0
    for k, v in want.items():
        assert got[k].dtype == v.dtype and got[k].shape == v.shape, k
        if torch.equal(got[k], v):
            continue
        folded += 1
        assert ".attention.w" in k or ".feed_forward.w" in k, k
        torch.testing.assert_close(got[k], v, rtol=0, atol=1e-6)
    assert (j / "meta.json").read_text() == (t / "meta.json").read_text()
    assert sorted(p.name for p in t.iterdir()) == sorted(
        p.name for p in j.iterdir())


def test_eval_cli_adapter_path_matches_jax(float32_cli, ckpt, tasks, adapters,
                                           merged_ckpts, tmp_path):
    """``eval_affordance --adapter_path`` at temperature 0 in float32 on
    the dense base: the results JSON byte for byte against the JAX CLI.
    The JAX CLI cannot decode through unmerged adapters, so it runs on
    its own ``merge_lora`` output of the same adapter."""
    _, tdir = adapters
    argv = ["--dataset", tasks, "--batch_size", "2", "--max_gen_len", "12",
            "--max_seq_len", str(MAX_SEQ), "--temperature", "0",
            "--input_size", str(SIZE)]
    want = jeval.main(argv + ["--pretrained_path", str(merged_ckpts / "j"),
                              "--output_dir", str(tmp_path / "j")])
    got = teval.main(argv + ["--pretrained_path", str(ckpt), "--adapter_path",
                             str(tdir), "--output_dir", str(tmp_path / "t"),
                             "--device", "cpu"])
    assert Path(got).read_bytes() == Path(want).read_bytes()
    # the int4 base serves the same adapter through the CLI
    quant = teval.main(argv + ["--pretrained_path", str(ckpt),
                               "--adapter_path", str(tdir), "--quant",
                               "--output_dir", str(tmp_path / "q"),
                               "--device", "cpu"])
    assert len(json.loads(Path(quant).read_text())) == 6


@pytest.fixture
def float32_cli(tiny_towers, monkeypatch):
    """Both packages' ``from_pretrained`` load in float32, so the two CLIs
    can be held byte for byte."""
    for cls, dtype in ((JMetaModel, jnp.float32), (MetaModel, torch.float32)):
        real = cls.from_pretrained.__func__
        monkeypatch.setattr(cls, "from_pretrained", classmethod(
            lambda c, *a, _real=real, _dtype=dtype, **kw: _real(
                c, *a, **{**kw, "dtype": _dtype})))


def test_convert_weights_to_hf_matches_jax(ckpt, tmp_path):
    """The decoder of the tiny checkpoint as a HuggingFace LLaMA state
    dict and config: the same files."""
    for mod, d in ((jhf, "j"), (thf, "t")):
        mod.convert([str(ckpt)], str(tmp_path / d), n_layers=2, n_heads=4)
    want = torch.load(tmp_path / "j" / "pytorch_model.bin", weights_only=True)
    got = torch.load(tmp_path / "t" / "pytorch_model.bin", weights_only=True)
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert (tmp_path / "t" / "config.json").read_text() == (
        tmp_path / "j" / "config.json").read_text()


def test_weight_operate_matches_jax(ckpt, tmp_path):
    """Extract a diff checkpoint (fine-tuned - base) and apply it again:
    each tool writes the same tensors, and the applied one is the
    fine-tuned one."""
    name = "consolidated.00-of-01.model.pth"
    base = torch.load(ckpt / name, weights_only=True)["model"]
    g = torch.Generator().manual_seed(6)
    tuned = {k: v + 0.01 * torch.randn(v.shape, generator=g)
             for k, v in base.items()}
    tuned["llma.extra_tag"] = torch.randn(1, 1, 4, generator=g)
    (tmp_path / "ft").mkdir()
    torch.save({"model": tuned}, tmp_path / "ft" / name)
    for mod, d in ((jweights, "j"), (tweights, "t")):
        mod.operate(str(ckpt), str(tmp_path / "ft"),
                    str(tmp_path / d / "diff"), "extract")
        mod.operate(str(ckpt), str(tmp_path / d / "diff"),
                    str(tmp_path / d / "applied"), "apply")
    for sub in ("diff", "applied"):
        names = sorted(p.name for p in (tmp_path / "j" / sub).iterdir())
        assert names == sorted(p.name for p in (tmp_path / "t" / sub)
                               .iterdir())
        for n in names:
            want = torch.load(tmp_path / "j" / sub / n, weights_only=True)
            got = torch.load(tmp_path / "t" / sub / n, weights_only=True)
            assert got["model"].keys() == want["model"].keys()
            for k, v in want["model"].items():
                assert torch.equal(got["model"][k], v), (sub, k)
    applied = torch.load(tmp_path / "t" / "applied" / name,
                         weights_only=True)["model"]
    for k, v in tuned.items():
        torch.testing.assert_close(applied[k], v, rtol=0, atol=1e-6)
