"""Training on several ranks (``main_finetune``'s step on a ("data",
"model") mesh) against the JAX package's step under ``jax.sharding.Mesh``
on the host devices, on the CPU: one spawn of four gloo ranks for the
module (``tests/torch_parallel_train_ranks.py``), tiny configs in float32,
one thread a rank.

- the tiny llama_ens5 QLoRA step at data 2 x model 2: an int4 base packed
  for model 2 (``tp_align`` 256, the all-column tree), rank-4 adapters,
  accumulation 2, remat, the clip active, rows of unequal label counts:
  loss and grad norm of each of two steps, the updated trainables;
- the llama_ens5_2images step at data 2 x model 2 (both image streams
  through the crop-split towers);
- the loss of rows with unequal label counts: the mean over the whole
  batch's valid tokens (not a mean of the ranks' means) and its gradient;
- a checkpoint saved at data 2 x model 2: its files' tensors equal a
  one-device save of the same state byte for byte, and it restores at
  data 1 x model 4 leaf for leaf.

Tolerances: loss and grad norm to a relative 1e-5 and the updated
trainables to 1e-5 absolute (tests/test_torch_train.py's: only summation
order and the collectives' float32 sums differ); replicated trainables
the same bytes on every rank; the checkpoint exact."""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_train_ranks as ranks
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP
from test_torch_families import numpy_tree
from test_torch_train import _assert_trees_close

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import ens5_2images as je2
from a3vlm_tpu.parallel import create_mesh as jcreate_mesh
from a3vlm_tpu.parallel import shard_params as jshard_params
from a3vlm_tpu.train import lora as jlora
from a3vlm_tpu.train import step as jstep
from a3vlm_tpu.train.losses import next_token_loss as j_next_token_loss
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from a3vlm_tpu_torch.checkpoint.manager import (
    MODEL_FILE,
    OPTIMIZER_FILE,
    CheckpointManager,
)
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.main_finetune import make_loss_fn, qlora_trainable_mask
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models.falcon import FalconArgs
from a3vlm_tpu_torch.parallel.launch import run_spmd
from a3vlm_tpu_torch.train.losses import next_token_loss
from a3vlm_tpu_torch.train.step import (
    AdamWState,
    TrainState,
    combine_params,
    make_optimizer,
    make_train_step,
    partition_params,
)

torch.set_num_threads(1)
TRUE_VOCAB = 100
DIM = 256  # the linears' columns split over model 2 (N % 256 == 0)
LR, CLIP = 1e-3, 0.1
CPU4 = ["cpu"] * 4


def tiny_cfgs():
    """The JAX and the port's tiny ens5 config at width ``DIM``."""
    j = jens5.tiny_ens5_config(vocab_size=128)
    t = tiny_ens5_config(128)
    return (dataclasses.replace(j, llama=dataclasses.replace(j.llama,
                                                             dim=DIM)),
            dataclasses.replace(t, llama=dataclasses.replace(t.llama,
                                                             dim=DIM)))


def family_setup(family: str, seed: int, tp_align: int = 256):
    """One family's tiny tree from numpy, its decoder packed int4 for
    ``tp_align``, rank-4 adapters with random ``b``, the CLI's mask: the
    JAX side, and the port's model and adapters from the same numbers."""
    jcfg, tcfg = tiny_cfgs()
    init = jens5.init_ens5_params if family == "llama_ens5" \
        else je2.init_params
    tree = numpy_tree(init, jcfg, seed)
    tree["llama"] = jquant.quantize_params(
        jax.tree_util.tree_map(jnp.asarray, tree["llama"]), bits=4,
        tp_align=tp_align)
    lora = jlora.init_lora_params(jax.random.PRNGKey(17), tree["llama"],
                                  rank=4)
    rng = np.random.default_rng(seed + 1)
    for items in lora["layers"].values():
        for ab in items.values():
            ab["b"] = jnp.asarray(
                0.05 * rng.normal(size=ab["b"].shape).astype(np.float32))
    jp = jax.tree_util.tree_map(jnp.asarray, tree)
    mask = jquant.freeze_quantized_mask(jp, jens5.trainable_mask(jp))
    mask = {**mask, "llama": jlora.lora_base_trainable_mask(jp["llama"]),
            "lora": jax.tree_util.tree_map(lambda _: True, lora)}
    full = {**jp, "lora": lora}
    tfull = params_from_numpy(jax.tree_util.tree_map(np.asarray, full),
                              device="cpu")
    model = MetaModel(family, with_visual=True, max_seq_len=512,
                      params={k: v for k, v in tfull.items() if k != "lora"},
                      vocab_size=TRUE_VOCAB, model_cfg=tcfg, device="cpu")
    return {"jcfg": jcfg, "jfull": full, "jmask": mask, "model": model,
            "lora": tfull["lora"], "family": family}


def make_batches(rows: int, steps: int, accum: int, seed: int,
                 depth: bool = False) -> list:
    """``steps`` batches [accum, rows, ...]: ids, labels masking a prompt
    of a different length on each row (so the data ranks hold different
    label counts), images (and depth images)."""
    out = []
    for s in range(steps):
        r = np.random.default_rng(seed + s)
        n = accum * rows
        ex = r.integers(3, TRUE_VOCAB, size=(n, 20))
        ex[:, 0] = 1
        lab = ex.copy()
        for i in range(n):
            lab[i, : 2 + 3 * i] = 0
        b = {"examples": ex, "labels": lab,
             "image": r.normal(size=(n, 56, 56, 3)).astype(np.float32)}
        if depth:
            b["depth_image"] = r.normal(size=(n, 56, 56, 3)).astype(
                np.float32)
        out.append({k: v.reshape(accum, rows, *v.shape[1:]) if accum > 1
                    else v for k, v in b.items()})
    return out


def torch_batches(batches):
    return [{k: torch.tensor(v) for k, v in b.items()} for b in batches]


def jax_mesh_steps(s, batches, mp: int, n: int, accum: int, remat: bool):
    """The JAX step on a mesh of ``n`` host devices, ``mp`` of them a
    model group, as the JAX CLI places it (main_finetune.py:364-433): each
    step's loss and grad norm, and the trainables after the last."""
    family = je2 if s["family"] == "llama_ens5_2images" else jens5
    jcfg = s["jcfg"]

    def loss_fn(params, batch):
        p = jlora.attach_lora_into_model(
            {k: v for k, v in params.items() if k != "lora"}, params["lora"])
        kw = ({"depth_image": batch["depth_image"]}
              if "depth_image" in batch else {})
        logits = family.forward(p, jcfg, batch["examples"],
                                image=batch["image"], remat=remat, **kw)
        return j_next_token_loss(logits, batch["labels"],
                                 vocab_size=TRUE_VOCAB)

    jp = {k: v for k, v in s["jfull"].items() if k != "lora"}
    specs = jens5.ens5_partition_specs(jcfg, jp)
    specs["llama"] = jquant.quantized_partition_specs(specs["llama"],
                                                      jp["llama"], mp)
    specs["lora"] = jlora.lora_partition_specs(s["jfull"]["lora"])
    mesh = jcreate_mesh(mp, jax.devices()[:n])
    opt = jstep.make_optimizer(LR, max_grad_norm=CLIP)
    metrics = []
    with mesh:
        state = jax.jit(lambda p: jstep.TrainState.create(
            p, opt, s["jmask"]))(jshard_params(s["jfull"], mesh, specs))
        step = jax.jit(jstep.make_train_step(loss_fn, opt, accum,
                                             s["jmask"]))
        for b in batches:
            lead = (None,) if accum > 1 else ()
            b = {k: jax.device_put(v, NamedSharding(mesh, JP(
                *lead, "data", *([None] * (v.ndim - len(lead) - 1)))))
                for k, v in b.items()}
            state, m = step(state, b)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
    trained = jstep.partition_params(state.params, s["jmask"])[0]
    return metrics, jax.tree_util.tree_map(np.asarray, trained)


@pytest.fixture(scope="module")
def qlora():
    return family_setup("llama_ens5", 21)


@pytest.fixture(scope="module")
def rgbd():
    return family_setup("llama_ens5_2images", 22)


@pytest.fixture(scope="module")
def loss_rows():
    r = np.random.default_rng(5)
    logits = torch.tensor(r.normal(size=(4, 12, 128)).astype(np.float32))
    logits[2:] *= 4  # the second data rank's rows: a much larger loss
    labels = torch.tensor(r.integers(1, TRUE_VOCAB, size=(4, 12)))
    for i, n in enumerate((1, 9, 3, 11)):  # unequal counts per data rank
        labels[i, :n] = 0
    return logits, labels


@pytest.fixture(scope="module")
def falcon():
    """A tiny falcon (grouped-query, 2 kv heads) and a batch of 4 rows
    with unequal label counts."""
    args = FalconArgs(num_layers=2, hidden_size=64, num_attention_heads=4,
                      num_kv_heads=2)
    model = MetaModel("falcon", max_seq_len=128, vocab_size=TRUE_VOCAB,
                      model_cfg=args, seed=3, device="cpu")
    r = np.random.default_rng(9)
    examples = torch.tensor(r.integers(3, TRUE_VOCAB, size=(4, 16)))
    labels = examples.clone()
    for i in range(4):
        labels[i, : 2 + 3 * i] = 0
    return model, examples, labels


@pytest.fixture(scope="module")
def four_ranks(qlora, rgbd, loss_rows, falcon, tmp_path_factory):
    """One spawn of four ranks for the module."""
    root = str(tmp_path_factory.mktemp("ckpt"))
    # copies: rank 0 runs here and updates its trainables in place
    runs = run_spmd(
        ranks.four_rank_train_suite, CPU4, copy.deepcopy(qlora["model"]),
        copy.deepcopy(qlora["lora"]),
        (copy.deepcopy(rgbd["model"]), copy.deepcopy(rgbd["lora"])),
        torch_batches(make_batches(4, 2, 2, seed=40)),
        torch_batches(make_batches(4, 2, 1, seed=50, depth=True)),
        *loss_rows, TRUE_VOCAB, root, copy.deepcopy(qlora["model"]), falcon,
        model_parallel_size=4)
    return {"runs": runs, "root": root}


def _hold_steps(runs, want_metrics, want_trained):
    for out in runs:
        np.testing.assert_allclose(np.asarray(out["metrics"]),
                                   np.asarray(want_metrics), rtol=1e-5)
        # replicated trainables: the same bytes on every rank
        for a, b in zip(out["replicated"], runs[0]["replicated"]):
            assert torch.equal(a, b)
    got = runs[0]["state"]["trainable"]
    _assert_trees_close(params_to_numpy(got), want_trained, atol=1e-5)


def test_qlora_step_at_data2_model2_matches_jax_mesh(qlora, four_ranks):
    """Two QLoRA steps (int4 all-column base, accumulation 2, remat, the
    clip active) at data 2 x model 2: loss, grad norm and the updated
    trainables as the JAX step's on a 2 x 2 mesh of host devices."""
    want = jax_mesh_steps(qlora, make_batches(4, 2, 2, seed=40), 2, 4, 2,
                          remat=True)
    _hold_steps([r["qlora"] for r in four_ranks["runs"]], *want)
    assert all(m[1] > CLIP for m in want[0])  # the clip acts


def test_qlora_step_at_data2_model2_matches_one_rank(qlora, four_ranks):
    """The same steps on one rank of the port: the same numbers."""
    model = copy.deepcopy(qlora["model"])
    mask = qlora_trainable_mask(model, qlora["lora"], quant=True)
    opt = make_optimizer(LR, max_grad_norm=CLIP)
    step = make_train_step(make_loss_fn(model, torch.float32, remat=True),
                           opt, 2, mask)
    state = TrainState.create({**model.params, "lora": copy.deepcopy(
        qlora["lora"])}, opt, mask)
    metrics = []
    for b in torch_batches(make_batches(4, 2, 2, seed=40)):
        state, m = step(state, b)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    runs = [r["qlora"] for r in four_ranks["runs"]]
    np.testing.assert_allclose(np.asarray(runs[0]["metrics"]),
                               np.asarray(metrics), rtol=1e-5)
    _assert_trees_close(params_to_numpy(runs[0]["state"]["trainable"]),
                        params_to_numpy(partition_params(state.params,
                                                         mask)[0]),
                        atol=1e-5)


def test_rgbd_step_at_data2_matches_jax_mesh(rgbd, four_ranks):
    """The llama_ens5_2images step (RGB and depth streams) at data 2 x
    model 2 against the JAX step on the same mesh."""
    want = jax_mesh_steps(rgbd, make_batches(4, 2, 1, seed=50, depth=True),
                          2, 4, 1, remat=False)
    _hold_steps([r["rgbd"] for r in four_ranks["runs"]], *want)


def test_loss_is_the_global_mean_over_unequal_rows(loss_rows, four_ranks):
    """Data ranks holding 13 and 19 valid labels: every rank's loss is the
    whole batch's mean, not the mean of the two ranks' means, and each
    rank's gradient is its rows of the whole batch's."""
    logits, labels = loss_rows
    whole = logits.clone().requires_grad_(True)
    want = next_token_loss(whole, labels, vocab_size=TRUE_VOCAB)
    want.backward()
    halves = [float(next_token_loss(logits[a:a + 2], labels[a:a + 2],
                                    vocab_size=TRUE_VOCAB)) for a in (0, 2)]
    for r in four_ranks["runs"]:
        out = r["loss"]
        np.testing.assert_allclose(out["loss"], float(want.detach()),
                                   rtol=1e-6)
        a = 2 * out["data_index"]
        torch.testing.assert_close(out["grad"], whole.grad[a:a + 2],
                                   atol=1e-7, rtol=0)
    assert abs(np.mean(halves) - float(want.detach())) > 0.5


def _stored(path):
    tree = torch.load(path, weights_only=True)
    out = {}

    def walk(x, p):
        if isinstance(x, dict):
            for k, v in x.items():
                walk(v, f"{p}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(v, f"{p}/{i}")
        else:
            out[p] = x
    walk(tree, "")
    return out


def test_checkpoint_at_data2_model2_is_the_one_device_save(qlora,
                                                            four_ranks,
                                                            tmp_path):
    """The mesh's save (rank 0 writes the gathered leaves) holds the
    tensors a one-device save of the same state holds, byte for byte."""
    got = four_ranks["runs"][0]["qlora"]["state"]
    model = qlora["model"]
    mask = qlora_trainable_mask(model, qlora["lora"], quant=True)
    frozen = partition_params({**model.params, "lora": qlora["lora"]},
                              mask)[1]
    CheckpointManager(str(tmp_path)).save(
        0, params=combine_params(got["trainable"], frozen),
        opt_state=AdamWState(got["count"], got["mu"], got["nu"]), step=2,
        trainable_mask=mask)
    mesh_dir = f"{four_ranks['root']}/mesh/epoch_0"
    for name in (MODEL_FILE, OPTIMIZER_FILE):
        a, b = _stored(f"{mesh_dir}/{name}"), _stored(tmp_path / "epoch_0"
                                                       / name)
        assert a.keys() == b.keys()
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k
            else:
                assert a[k] == b[k], k


def test_checkpoint_restores_at_data1_model4(four_ranks):
    """Restored into a data 1 x model 4 tree, every rank takes its block
    (a quarter of w1's adapter columns) and the gathered tree equals the
    saved state leaf for leaf."""
    got = four_ranks["runs"][0]
    saved, restored = got["qlora"]["state"], got["ckpt"]
    assert restored["count"] == saved["count"] == 2
    for a, b in ((restored["trainable"], saved["trainable"]),
                 (restored["mu"], saved["mu"])):
        la, lb = params_to_numpy(a), params_to_numpy(b)
        assert jax.tree_util.tree_structure(la) == \
            jax.tree_util.tree_structure(lb)
        for x, y in zip(jax.tree_util.tree_leaves(la),
                        jax.tree_util.tree_leaves(lb)):
            np.testing.assert_array_equal(x, y)
    cols = {r["ckpt"]["w1_b_cols"] for r in four_ranks["runs"]}
    assert cols == {saved["trainable"]["lora"]["layers"][0]["feed_forward"][
        "w1"]["b"].shape[-1] // 4}


def test_falcon_loss_on_a_mesh_matches_one_rank(falcon, four_ranks):
    """``MetaModel.forward`` of falcon at data 2 x model 2 (its TP blocks,
    the rows split over "data"): every rank's loss is one rank's, and the
    data ranks' LayerNorm gradients sum to one rank's."""
    model, examples, labels = falcon
    model = copy.deepcopy(model)
    norms = [lp["ln_attn"]["weight"] for lp in model.params["layers"]] + [
        model.params["ln_f"]["weight"]]
    for w in norms:
        w.requires_grad_(True)
    want = model.forward(examples, labels)
    want.backward()
    runs = [r["falcon"] for r in four_ranks["runs"]]
    for r in runs:
        np.testing.assert_allclose(r["loss"], float(want.detach()),
                                   rtol=1e-5)
    for i, w in enumerate(norms):
        for model_index in (0, 1):
            got = sum(r["grads"][i] for r in runs[model_index::2])
            torch.testing.assert_close(got, w.grad, atol=1e-5, rtol=0)
