"""The QLoRA training slice of the PyTorch port against the JAX package, on
the same numpy inputs in float32 (``torch.set_num_threads(1)``).

Tolerances: the int4 base is byte-identical on both sides, so only
summation order and transcendental rounding differ. Loss to a relative
1e-5; gradients to 1e-4 of each leaf's largest magnitude (the gradient of
a rank-r adapter sums over every token, which amplifies order effects);
parameters after two AdamW updates to 1e-5 (an update moves each element
by about the learning rate, 1e-3, so that is 1% of a step); the optimizer
alone bit for bit, or to 1e-6 where the clip's global norm or the
schedule rounds differently; the schedules to 1e-6 relative."""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.ops.quant_matmul import qmat as j_qmat
from a3vlm_tpu.quant import LoraWeight as JLoraWeight
from a3vlm_tpu.quant import freeze_quantized_mask as j_freeze_quantized_mask
from a3vlm_tpu.quant import quantize_params as j_quantize_params
from a3vlm_tpu.train import lr_sched as jlr
from a3vlm_tpu.train import step as jstep
from a3vlm_tpu.train.losses import next_token_loss as j_next_token_loss
from a3vlm_tpu.train.lora import attach_lora_into_model as j_attach_lora
from a3vlm_tpu.train.lora import init_lora_params as j_init_lora_params
from a3vlm_tpu.train.lora import (
    lora_base_trainable_mask as j_lora_base_trainable_mask,
)
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.main_finetune import make_loss_fn, qlora_trainable_mask
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import ens5 as tens5
from a3vlm_tpu_torch.ops.quant_matmul import qmat
from a3vlm_tpu_torch.parallel.tp import Shard
from a3vlm_tpu_torch.quant import LoraWeight, QuantizedWeight
from a3vlm_tpu_torch.quant import _quantize_leaf_int4
from a3vlm_tpu_torch.train import lr_sched
from a3vlm_tpu_torch.train.losses import next_token_loss
from a3vlm_tpu_torch.train.step import (
    TrainState,
    accumulated_value_and_grad,
    make_optimizer,
    make_train_step,
    partition_params,
)

torch.set_num_threads(1)
TRUE_VOCAB = 100
LR = 1e-3


def _leaves(tree, prefix=""):
    """{path: array} of a nested dict/list tree (JAX int4 nodes and None
    skipped)."""
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_leaves(v, f"{prefix}/{k}"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_leaves(v, f"{prefix}/{i}"))
    elif tree is not None and not hasattr(tree, "q"):
        out[prefix] = np.asarray(tree, np.float32)
    return out


def _assert_trees_close(got, want, rel=None, atol=None):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for path, w in want.items():
        tol = atol if atol is not None else rel * max(np.abs(w).max(), 1e-30)
        np.testing.assert_allclose(got[path], w, rtol=0, atol=tol,
                                   err_msg=path)


@pytest.fixture(scope="module")
def slice_setup():
    """Tiny llama_ens5, int4 decoder, rank-4 adapters with random ``b``,
    the main_finetune mask, on both sides from the same numpy tree."""
    jcfg = jens5.tiny_ens5_config(vocab_size=128)
    # the init's shapes, filled from numpy (faster than running the init)
    shapes = jax.eval_shape(lambda k: jens5.init_ens5_params(k, jcfg),
                            jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)
    jp = jax.tree_util.tree_map(
        lambda s: jnp.asarray(
            (0.05 * rng.normal(size=s.shape)).astype(np.float32)), shapes)
    jp = {**jp, "llama": j_quantize_params(jp["llama"], bits=4)}
    jlora = j_init_lora_params(jax.random.PRNGKey(17), jp["llama"], rank=4)
    for items in jlora["layers"].values():
        for ab in items.values():
            ab["b"] = jnp.asarray(
                0.05 * rng.normal(size=ab["b"].shape).astype(np.float32))
    jmask = j_freeze_quantized_mask(jp, jens5.trainable_mask(jp))
    jmask = {**jmask, "llama": j_lora_base_trainable_mask(jp["llama"]),
             "lora": jax.tree_util.tree_map(lambda _: True, jlora)}
    jfull = {**jp, "lora": jlora}

    tree = jax.tree_util.tree_map(np.asarray, jfull)
    tfull = params_from_numpy(tree, device="cpu")
    model = MetaModel("llama_ens5", with_visual=True, max_seq_len=512,
                      params={k: v for k, v in tfull.items() if k != "lora"},
                      vocab_size=TRUE_VOCAB, model_cfg=tiny_ens5_config(),
                      device="cpu")
    tmask = qlora_trainable_mask(model, tfull["lora"], quant=True)

    def batch(n, seed):
        r = np.random.default_rng(seed)
        ex = r.integers(3, TRUE_VOCAB, size=(n, 16))
        ex[:, 0] = 1
        lab = ex.copy()
        lab[:, :5] = 0  # the prompt
        img = r.normal(size=(n, 56, 56, 3)).astype(np.float32)
        return {"examples": ex, "labels": lab, "image": img}

    return {"jcfg": jcfg, "jfull": jfull, "jmask": jmask, "tree": tree,
            "model": model, "tmask": tmask, "batch": batch}


def _jax_loss(jcfg, remat, impl):
    def loss_fn(params, batch):
        p = j_attach_lora({k: v for k, v in params.items() if k != "lora"},
                          params["lora"])
        logits = jens5.forward(p, jcfg, batch["examples"],
                               image=batch["image"], remat=remat, impl=impl)
        return j_next_token_loss(logits, batch["labels"],
                                 vocab_size=TRUE_VOCAB)

    return loss_fn


def _jax_grads(loss_fn, params, mask, batch, accum):
    """Loss and averaged gradients as the JAX train step forms them."""
    t, f = jstep.partition_params(params, mask)
    vg = jax.jit(jax.value_and_grad(
        lambda t, b: loss_fn(jstep.combine_params(t, f), b)))
    if accum == 1:
        return vg(t, batch)
    out = [vg(t, jax.tree_util.tree_map(lambda x, a=a: x[a], batch))
           for a in range(accum)]
    loss = sum(o[0] for o in out) / accum
    grads = jax.tree_util.tree_map(
        lambda *g: sum(g) / accum, *[o[1] for o in out])
    return loss, grads


def _schedule_kwargs():
    # the first update runs at lr 0 (warmup from count 0), the second at LR
    return dict(lr=LR, min_lr=0.0, warmup_epochs=0.5, epochs=2,
                updates_per_epoch=2)


@pytest.mark.parametrize("accum,impl", [(1, "auto"), (2, "auto"),
                                        (2, "flash")])
def test_qlora_step_matches_jax(slice_setup, accum, impl):
    """(g) Loss, every trainable gradient, and the parameters after two
    updates of the whole QLoRA step on tiny llama_ens5. Weight decay stays
    at the recipe's 0: the JAX step decays its stacked [L, D] decoder norm
    weights, which the port (per-layer [D] norms) and the reference recipe
    leave undecayed; ``test_optimizer_matches_optax`` covers decay."""
    from jax.experimental.pallas import tpu as pltpu

    s = slice_setup
    n = 2
    raw = s["batch"](n * accum, seed=accum)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    tb = {k: torch.tensor(v) for k, v in raw.items()}
    if accum > 1:
        jb = jax.tree_util.tree_map(
            lambda x: x.reshape(accum, n, *x.shape[1:]), jb)
        tb = {k: v.reshape(accum, n, *v.shape[1:]) for k, v in tb.items()}

    jloss = _jax_loss(s["jcfg"], remat=False, impl=impl)
    jopt = jstep.make_optimizer(
        jlr.make_epoch_schedule(**_schedule_kwargs()), max_grad_norm=1.0)
    with pltpu.force_tpu_interpret_mode():
        j_loss, j_grads = _jax_grads(jloss, s["jfull"], s["jmask"], jb, accum)
        train = jax.jit(jstep.make_train_step(jloss, jopt, accum,
                                              s["jmask"]))
        jstate = jstep.TrainState.create(s["jfull"], jopt, s["jmask"])
        for _ in range(2):
            jstate, _ = train(jstate, jb)

    tparams = params_from_numpy(s["tree"], device="cpu")
    tloss_fn = make_loss_fn(s["model"], torch.float32, remat=False,
                            impl=impl)
    trainable, frozen = partition_params(tparams, s["tmask"])
    t_loss, t_grads = accumulated_value_and_grad(tloss_fn, trainable, frozen,
                                                 tb, accum)
    np.testing.assert_allclose(float(t_loss), float(j_loss), rtol=1e-5)
    _assert_trees_close(params_to_numpy(t_grads), j_grads, rel=1e-4)

    topt = make_optimizer(lr_sched.make_epoch_schedule(**_schedule_kwargs()),
                          max_grad_norm=1.0)
    step = make_train_step(tloss_fn, topt, accum, s["tmask"])
    tstate = TrainState.create(tparams, topt, s["tmask"])
    for _ in range(2):
        tstate, metrics = step(tstate, tb)
    assert tstate.step == 2 and tstate.opt_state.count == 2
    assert np.isfinite(float(metrics["grad_norm"]))
    got = partition_params(tstate.params, s["tmask"])[0]
    want = jstep.partition_params(jstate.params, s["jmask"])[0]
    _assert_trees_close(params_to_numpy(got), want, atol=1e-5)
    # the base stayed packed and untouched
    wq = tstate.params["llama"]["layers"][0]["attention"]["wq"]["weight"]
    assert isinstance(wq, QuantizedWeight) and wq.q.dtype == torch.int8
    np.testing.assert_array_equal(
        wq.q.numpy(),
        np.asarray(s["jfull"]["llama"]["layers"]["attention"]["wq"][
            "weight"].q[0]))


def test_remat_gives_the_same_grads(slice_setup):
    """(h) Per-block recompute changes no gradient."""
    s = slice_setup
    tb = {k: torch.tensor(v) for k, v in s["batch"](2, seed=5).items()}
    tparams = params_from_numpy(s["tree"], device="cpu")
    trainable, frozen = partition_params(tparams, s["tmask"])
    out = []
    for remat in (False, True):
        fn = make_loss_fn(s["model"], torch.float32, remat=remat)
        out.append(accumulated_value_and_grad(fn, trainable, frozen, tb))
    assert float(out[0][0]) == float(out[1][0])
    _assert_trees_close(params_to_numpy(out[1][1]),
                        params_to_numpy(out[0][1]), atol=1e-7)


def test_tower_features_replace_the_towers(slice_setup):
    """``image_features`` (the towers' output) in place of the image gives
    the same image tokens, and the projectors and tags get a gradient
    while the towers run without one."""
    s = slice_setup
    params = params_from_numpy(s["tree"], device="cpu")
    cfg = s["model"].cfg
    image = torch.tensor(s["batch"](2, seed=9)["image"])
    proj = params["visual_proj"]["linear"]["weight"].requires_grad_()
    from_image = tens5.build_image_tokens(params, cfg, image)
    feats = tens5.encode_image_features(params, cfg, image)
    assert not feats["ens"].requires_grad
    from_feats = tens5.build_image_tokens(params, cfg, image_features=feats)
    torch.testing.assert_close(from_feats, from_image, rtol=0, atol=0)
    (grad,) = torch.autograd.grad(from_feats.sum(), proj)
    assert float(grad.abs().max()) > 0


def test_qmat_quant_and_lora_grads_match_jax():
    """(c) d/dx through the packed int4 base (input dim 1100, padded to
    2048 inside the product) and the adapter grads."""
    rng = np.random.default_rng(11)
    K, N, r = 1100, 48, 4
    w = (rng.normal(size=(K, N)) / K ** 0.5).astype(np.float32)
    x = rng.normal(size=(3, 5, K)).astype(np.float32)
    a = (0.02 * rng.normal(size=(K, r))).astype(np.float32)
    b = (0.05 * rng.normal(size=(r, N))).astype(np.float32)
    g = rng.normal(size=(3, 5, N)).astype(np.float32)

    jw = j_quantize_params({"m": {"w": {"weight": w}}}, bits=4)["m"]["w"][
        "weight"]

    def jloss(x, a, b):
        return jnp.sum(j_qmat(x, JLoraWeight(jw, a, b)) * g)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(a),
                                              jnp.asarray(b))
    tw = _quantize_leaf_int4(torch.tensor(w))
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    assert tw.q.shape[0] * 2 == 2048 and tw.in_dim == K
    tx, ta, tb = (torch.tensor(v, requires_grad=True) for v in (x, a, b))
    out = qmat(tx, LoraWeight(tw, ta, tb))
    got = torch.autograd.grad((out * torch.tensor(g)).sum(), (tx, ta, tb))
    assert got[0].shape == tx.shape
    for gt, wt in zip(got, want):
        np.testing.assert_allclose(gt.numpy(), np.asarray(wt), rtol=0,
                                   atol=1e-4 * np.abs(np.asarray(wt)).max())


def test_next_token_loss_matches_jax():
    """(d) Shifted CE with label 0 ignored and the padded vocab masked;
    exactly 0, with zero gradient, on an all-ignored batch."""
    rng = np.random.default_rng(2)
    logits = rng.normal(size=(2, 7, 130)).astype(np.float32)
    labels = rng.integers(0, 100, size=(2, 7))
    labels[0, 3] = 0
    want = j_next_token_loss(jnp.asarray(logits), jnp.asarray(labels),
                             vocab_size=100)
    got = next_token_loss(torch.tensor(logits), torch.tensor(labels),
                          vocab_size=100)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    no_vocab = j_next_token_loss(jnp.asarray(logits), jnp.asarray(labels))
    np.testing.assert_allclose(
        float(next_token_loss(torch.tensor(logits), torch.tensor(labels))),
        float(no_vocab), rtol=1e-6)

    tl = torch.tensor(logits, requires_grad=True)
    zero = next_token_loss(tl, torch.zeros(2, 7, dtype=torch.long), 100)
    assert float(zero.detach()) == 0.0
    (grad,) = torch.autograd.grad(zero, tl)
    assert float(grad.abs().max()) == 0.0


def test_lr_schedules_match_jax():
    """(e) The schedules at a grid of counts, with and without warmup."""
    for warm in (0.0, 0.3):
        kw = dict(lr=2e-5, min_lr=1e-6, warmup_epochs=warm, epochs=3)
        jsched = jlr.make_epoch_schedule(updates_per_epoch=7, start_epoch=1,
                                         **kw)
        tsched = lr_sched.make_epoch_schedule(updates_per_epoch=7,
                                              start_epoch=1, **kw)
        for count in range(0, 20, 3):
            np.testing.assert_allclose(tsched(count), float(jsched(count)),
                                       rtol=1e-6, atol=1e-12)
        for frac in (0.0, 0.1, 0.3, 1.7, 3.0):
            assert lr_sched.adjust_learning_rate_epoch(frac, **kw) == \
                pytest.approx(jlr.adjust_learning_rate_epoch(frac, **kw),
                              rel=1e-12)
    first = lr_sched.make_epoch_schedule(
        lr=1.0, min_lr=0.0, warmup_epochs=0.5, epochs=1,
        updates_per_epoch=4)
    assert first(0) == 0.0
    assert lr_sched.cosine_lr(5, lr=1.0, min_lr=0.1, warmup_iters=10,
                              total_iters=110) == 0.5


@pytest.mark.parametrize("max_norm,scheduled,atol", [
    (100.0, False, 0.0),   # bit for bit
    (0.5, False, 1e-6),    # the clip: one rounding of the global norm
    (100.0, True, 1e-6),   # the schedule: Python vs float32 cosine
])
def test_optimizer_matches_optax(max_norm, scheduled, atol):
    """(f) Two updates of clip + AdamW with weight decay on the 2-D leaves
    only, against optax, the clip inactive (100) and active (0.5). The two
    global norms sum their leaves in other orders, and the port evaluates
    the schedule in Python where the JAX one runs in float32; without
    either the updates are bit-identical."""
    rng = np.random.default_rng(4)
    shapes = {"w": (5, 3), "bias": (3,), "n": {"g": (4,), "m": (2, 6)}}

    def make():
        return jax.tree_util.tree_map(
            lambda s: rng.normal(size=s).astype(np.float32), shapes,
            is_leaf=lambda x: isinstance(x, tuple))

    params, grads = make(), [make() for _ in range(2)]
    kw = dict(lr=0.1, min_lr=0.0, warmup_epochs=0, epochs=1,
              updates_per_epoch=4)
    jopt = jstep.make_optimizer(
        jlr.make_epoch_schedule(**kw) if scheduled else 0.1,
        max_grad_norm=max_norm, weight_decay=0.1)
    topt = make_optimizer(
        lr_sched.make_epoch_schedule(**kw) if scheduled else 0.1,
        max_grad_norm=max_norm, weight_decay=0.1)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jstate = jopt.init(jp)
    tp = jax.tree_util.tree_map(torch.tensor, params)
    tstate = topt.init(tp)
    for g in grads:
        upd, jstate = jopt.update(jax.tree_util.tree_map(jnp.asarray, g),
                                  jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tstate, norm = topt.update(jax.tree_util.tree_map(torch.tensor, g),
                                   tstate, tp)
        np.testing.assert_allclose(float(norm),
                                   float(optax.global_norm(g)), rtol=1e-6)
    assert tstate.count == 2
    _assert_trees_close(jax.tree_util.tree_map(lambda t: t.numpy(), tp), jp,
                        atol=atol)


def _write_dialog_data(tmp_path, n=8):
    img = tmp_path / "img.png"
    Image.new("RGB", (64, 48), (10, 200, 30)).save(img)
    records = [{"image": str(img), "conversations": [
        {"from": "human", "value": f"Where is door {i}?"},
        {"from": "gpt", "value": f"door {i} here"}]} for i in range(n)]
    (tmp_path / "tasks.json").write_text(json.dumps(records))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n - path: {tmp_path / 'tasks.json'}\n"
                   "   type: image_text\n")
    return cfg


def test_finetune_cli_qlora_runs(tmp_path, tiny_tokenizer_dir):
    """(i) The port's CLI on the QLoRA flags: steps run, the base stays
    packed, adapters and the other trainables stay float32 masters while
    the frozen towers are bf16."""
    from a3vlm_tpu_torch import main_finetune

    argv = [
        "--tokenizer_path", tiny_tokenizer_dir,
        "--data_config", str(_write_dialog_data(tmp_path)), "--dialog",
        "--tiny_random_model", "--quant", "--quant_bits", "4",
        "--lora_rank", "4", "--only_save_trainable", "--checkpointing",
        "--batch_size", "2", "--epochs", "1", "--warmup_epochs", "0",
        "--lr", "1e-4", "--max_words", "256", "--device", "cpu",
        "--output_dir", str(tmp_path / "out"), "--print_freq", "1",
    ]
    state = main_finetune.main(argv)
    assert state.step >= 1
    p = state.params
    wq = p["llama"]["layers"][0]["attention"]["wq"]["weight"]
    assert isinstance(wq, QuantizedWeight)
    assert wq.q.dtype == torch.int8 and wq.scale.dtype == torch.float32
    ab = p["lora"]["layers"][0]["attention"]["wq"]
    assert ab["a"].dtype == torch.float32 and ab["b"].dtype == torch.float32
    assert float(ab["b"].abs().max()) > 0  # the adapters trained
    assert p["llama"]["norm"]["weight"].dtype == torch.float32
    assert p["visual_proj"]["linear"]["weight"].dtype == torch.float32
    assert p["clip"]["class_embedding"].dtype == torch.bfloat16
    log = (tmp_path / "out" / "log.txt").read_text().splitlines()
    assert len(log) == 1 and np.isfinite(json.loads(log[0])["closs"])
    # the save flags write checkpoints: the end of the epoch, trainables
    # only, finalized
    assert (tmp_path / "out" / "epoch_0" / "_DONE").exists()

    # two ranks at model 2 train: the int4 base packed for them (the ffn
    # padded to 256, w1's columns split), the adapters trained on each
    mp2 = main_finetune.main(argv + [
        "--model_parallel_size", "2", "--num_devices", "2", "--devices",
        "cpu,cpu", "--output_dir", str(tmp_path / "mp2")])
    assert mp2.step == state.step
    w1 = mp2.params["llama"]["layers"][0]["feed_forward"]["w1"]["weight"]
    assert isinstance(w1, Shard) and isinstance(w1.local, QuantizedWeight)
    assert w1.local.q.shape[-1] == 128
    b1 = mp2.params["lora"]["layers"][0]["feed_forward"]["w1"]["b"]
    assert float(b1.local.abs().max()) > 0
    assert (tmp_path / "mp2" / "epoch_0" / "_DONE").exists()
    # what is not ported still says so
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main_finetune.main(argv + ["--profile_dir", str(tmp_path / "prof")])

    # an int8 base trains the same way (the later flag wins)
    state8 = main_finetune.main(argv + ["--quant_bits", "8"])
    wq8 = state8.params["llama"]["layers"][0]["attention"]["wq"]["weight"]
    assert state8.step >= 1 and wq8.bits == 8 and wq8.q.shape == (64, 64)
    ab8 = state8.params["lora"]["layers"][0]["attention"]["wq"]
    assert float(ab8["b"].abs().max()) > 0


def test_port_training_imports_no_jax():
    """(j) The port's training entry point imports no JAX module and
    nothing of the JAX package, neither when it is imported nor with the
    modules ``main`` loads to run."""
    code = ("import sys, a3vlm_tpu_torch.main_finetune, "
            "a3vlm_tpu_torch.data.alpaca, a3vlm_tpu_torch.data.dialog, "
            "a3vlm_tpu_torch.data.loader, a3vlm_tpu_torch.data.sampler, "
            "a3vlm_tpu_torch.data.transforms, a3vlm_tpu_torch.tokenizer, "
            "a3vlm_tpu_torch.config, a3vlm_tpu_torch.meta, "
            "a3vlm_tpu_torch.train.engine, a3vlm_tpu_torch.train.step, "
            "a3vlm_tpu_torch.train.lr_sched, a3vlm_tpu_torch.utils.logging, "
            "a3vlm_tpu_torch.utils.tensor_type; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'a3vlm_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"
