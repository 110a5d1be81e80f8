"""What each rank runs in the port's training tests on several ranks
(``tests/test_torch_parallel_train*.py``): functions of ``(mesh, *args)``
for ``parallel.launch.run_spmd``. The ranks are new processes: this module
imports torch and the port only, no JAX."""

import copy

import torch

from a3vlm_tpu_torch.parallel import mesh as pmesh
from a3vlm_tpu_torch.parallel import tp
from a3vlm_tpu_torch.quant import LoraWeight
from a3vlm_tpu_torch.train.step import split_flags, tree_leaves


def whole(tree, mesh):
    """``tree`` with every ``Shard`` gathered to its whole leaf."""
    if isinstance(tree, dict):
        return {k: whole(v, mesh) for k, v in tree.items()}
    if isinstance(tree, list):
        return [whole(v, mesh) for v in tree]
    if isinstance(tree, tp.Shard):
        return tp.gather_shard(tree, mesh)
    return tree


def replicated(tree) -> list:
    """The replicated leaves of ``tree`` (no ``Shard``), in order."""
    return [x for x, s in zip(tree_leaves(tree), split_flags(tree)) if not s]


# ------------------------------------------------------------- the products


def product_grads(mesh, case):
    """One tensor-parallel product of ``case`` (``kind`` "column", "row",
    "head" or "embed"; the full weight ``w``, its ``spec``, optional
    adapters ``a`` / ``b``; the input ``x``, the output's cotangent ``g``)
    on this rank's shard: the whole output, x's gradient (this rank's
    share of it for "row") and the adapters' gradients (this rank's
    blocks)."""
    from a3vlm_tpu_torch.train.lora import lora_partition_specs

    kind = case["kind"]
    with pmesh.use_mesh(mesh):
        w = pmesh.shard_params({"w": case["w"]}, mesh, {"w": case["spec"]})["w"]
        leaves = {}
        if case.get("a") is not None:
            name = "wo" if kind == "row" else "wq"
            specs = lora_partition_specs(
                {"layers": [{"g": {name: {"a": 0, "b": 0}}}]})
            ab = pmesh.shard_params({"a": case["a"], "b": case["b"]}, mesh,
                                    specs["layers"][0]["g"][name])
            for k in ("a", "b"):
                t = tp.local_weight(ab[k]).clone().requires_grad_(True)
                leaves[k] = t
                ab[k] = ab[k].with_local(t) if isinstance(
                    ab[k], tp.Shard) else t
            w = LoraWeight(w, ab["a"], ab["b"])
        if kind == "embed":
            table = tp.local_weight(w).clone().requires_grad_(True)
            leaves["w"] = table
            w = w.with_local(table) if isinstance(w, tp.Shard) else table
            y = tp.embed(w, case["x"])
            x = None
        else:
            x = case["x"].clone()
            if kind == "row":
                x = tp._share(x, mesh)
            x.requires_grad_(True)
            fn = {"column": tp.column, "row": tp.row, "head": tp.head}[kind]
            y = fn(x, w)
            if kind == "column":
                y = pmesh.gather(y, mesh, -1)
        (y * case["g"]).sum().backward()
    out = {"y": y.detach(), "dx": None if x is None else x.grad}
    out.update({f"d{k}": t.grad for k, t in leaves.items()})
    return out


def count_collectives(fn):
    """``fn()``'s result and the torch.distributed collectives it called,
    by name."""
    import torch.distributed as dist

    names = ("all_reduce", "all_gather", "all_gather_into_tensor",
             "reduce_scatter_tensor", "broadcast", "barrier")
    counts = dict.fromkeys(names, 0)
    saved = {n: getattr(dist, n) for n in names}

    def wrap(n):
        def call(*args, **kwargs):
            counts[n] += 1
            return saved[n](*args, **kwargs)
        return call

    for n in names:
        setattr(dist, n, wrap(n))
    try:
        out = fn()
    finally:
        for n, f in saved.items():
            setattr(dist, n, f)
    return out, {n: c for n, c in counts.items() if c}


# ------------------------------------------------------------- the steps


def qlora_steps(mesh, mp, model, lora, batches, accum, lr, clip,
                remat=True, quant=True):
    """Train ``model`` (its whole tree on every rank) with ``lora`` on a
    mesh of ``mp`` model ranks over this spawn's ranks, the CLI's recipe
    at float32: one step per batch of ``batches`` (each [accum, rows,
    ...]). Returns each step's loss and grad norm, this rank's replicated
    trainables after the last step and (rank 0) the whole trained state:
    trainables, moments."""
    from a3vlm_tpu_torch.main_finetune import (
        make_loss_fn,
        qlora_trainable_mask,
        train_partition_specs,
    )
    from a3vlm_tpu_torch.parallel.mesh import create_mesh
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
        partition_params,
    )

    # the arguments arrive in memory every rank shares: each updates its own
    model, lora = copy.deepcopy(model), copy.deepcopy(lora)
    grid = create_mesh(mp, mesh.devices)
    mask = qlora_trainable_mask(model, lora, quant=quant)
    params = pmesh.shard_params({**model.params, "lora": lora}, grid,
                                train_partition_specs(model, lora, mp))
    model.params = {k: v for k, v in params.items() if k != "lora"}
    model.mesh = grid
    opt = make_optimizer(lr, max_grad_norm=clip)
    step = make_train_step(make_loss_fn(model, torch.float32, remat=remat),
                           opt, accum, mask, mesh=grid)
    state = TrainState.create(params, opt, mask)
    metrics = []
    for batch in batches:
        state, m = step(state, batch)
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
    trainable = partition_params(state.params, mask)[0]
    out = {"metrics": metrics, "replicated": replicated(trainable),
           "rank": mesh.rank}
    got = {"trainable": whole(trainable, grid),
           "mu": whole(state.opt_state.mu, grid),
           "nu": whole(state.opt_state.nu, grid),
           "count": state.opt_state.count}
    if mesh.rank == 0:
        out["state"] = got
    return out, (grid, state, mask)


def loss_on_rows(mesh, logits, labels, vocab):
    """``next_token_loss`` of this data rank's rows of a whole batch of
    ``logits`` / ``labels`` at data 2 x model 2, and its gradient for
    those rows."""
    from a3vlm_tpu_torch.parallel.mesh import create_mesh
    from a3vlm_tpu_torch.train.losses import next_token_loss

    grid = create_mesh(2, mesh.devices)
    B = logits.shape[0]
    rows = tp.data_rows(logits, B, grid).clone().requires_grad_(True)
    loss = next_token_loss(rows, tp.data_rows(labels, B, grid),
                           vocab_size=vocab, data_mesh=grid)
    loss.backward()
    return {"loss": float(loss.detach()), "grad": rows.grad,
            "data_index": grid.data_index}


def checkpoint_across_meshes(mesh, trained, root, model4, lora):
    """Save the state of ``trained`` (``qlora_steps``' mesh, state and
    mask) on its mesh, trainables only; then restore it into ``model4``'s
    tree (the same model, whole) split at data 1 x model 4, and return the
    restored trainables and moments gathered whole (rank 0)."""
    from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager
    from a3vlm_tpu_torch.main_finetune import train_partition_specs
    from a3vlm_tpu_torch.parallel.mesh import create_mesh
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        partition_params,
    )

    grid, state, mask = trained
    mgr = CheckpointManager(root + "/mesh", mesh=grid)
    ckpt = mgr.save(0, params=state.params, opt_state=state.opt_state,
                    step=state.step, trainable_mask=mask, wait=False)
    mgr.wait_until_finished()
    mp4 = create_mesh(4, mesh.devices)
    params = pmesh.shard_params({**model4.params, "lora": lora}, mp4,
                                train_partition_specs(model4, lora, 4))
    opt = make_optimizer(1e-3)
    live = TrainState.create(params, opt, mask)
    mgr4 = CheckpointManager(root + "/mesh", mesh=mp4)
    restored = mgr4.restore_params(ckpt, live.params)
    extra = mgr4.restore_train_state(ckpt, live.opt_state)
    trainable = partition_params(restored, mask)[0]
    lo = tp.local_weight(trainable["lora"]["layers"][0]["feed_forward"][
        "w1"]["b"])
    out = {"trainable": whole(trainable, mp4),
           "mu": whole(extra["opt_state"].mu, mp4),
           "count": extra["opt_state"].count, "w1_b_cols": lo.shape[-1]}
    return out if mesh.rank == 0 else {"w1_b_cols": lo.shape[-1]}


def falcon_loss(mesh, model, examples, labels):
    """``MetaModel.forward`` of a falcon model split at data 2 x model 2
    (the whole batch on every rank): the loss and this rank's gradient of
    each LayerNorm weight (its data rows' part)."""
    from a3vlm_tpu_torch.models.falcon import falcon_partition_specs
    from a3vlm_tpu_torch.parallel.mesh import create_mesh

    grid = create_mesh(2, mesh.devices)
    model = copy.deepcopy(model)
    model.params = pmesh.shard_params(model.params, grid,
                                      falcon_partition_specs(model.args))
    model.mesh = grid
    norms = [lp["ln_attn"]["weight"] for lp in model.params["layers"]] + [
        model.params["ln_f"]["weight"]]
    for w in norms:
        w.requires_grad_(True)
    loss = model.forward(examples, labels)
    loss.backward()
    return {"loss": float(loss.detach()), "grads": [w.grad for w in norms],
            "data_index": grid.data_index}


def four_rank_train_suite(mesh, model, lora, rgbd, batches, rgbd_batches,
                          logits, labels, vocab, root, model4, falcon):
    """On four ranks: the QLoRA steps at data 2 x model 2, the 2-image
    model's steps at data 2 x model 2, the loss of rows with unequal label
    counts, the checkpoint of the QLoRA state saved there and restored at
    data 1 x model 4, falcon's loss at data 2 x model 2."""
    qlora, trained = qlora_steps(mesh, 2, model, lora, batches, accum=2,
                                 lr=1e-3, clip=0.1)
    out = {"qlora": qlora}
    out["rgbd"], _ = qlora_steps(mesh, 2, rgbd[0], rgbd[1], rgbd_batches,
                                 accum=1, lr=1e-3, clip=0.1, remat=False)
    out["loss"] = loss_on_rows(mesh, logits, labels, vocab)
    out["ckpt"] = checkpoint_across_meshes(mesh, trained, root, model4,
                                           lora)
    out["falcon"] = falcon_loss(mesh, *falcon)
    return out


def decoder_collectives(mesh, params, args, tokens):
    """The collectives of the tiny decoder's training forward on this
    rank's shard (``llama_partition_specs``, dense): under
    ``torch.no_grad``, recording a gradient (the norm weights trainable),
    and that forward's backward; and the logits of each forward."""
    from a3vlm_tpu_torch.models import llama

    local = pmesh.shard_params(params, mesh, llama.llama_partition_specs(
        args))
    norms = [lp[n]["weight"] for lp in local["layers"]
             for n in ("attention_norm", "ffn_norm")] + [
        local["norm"]["weight"]]
    with pmesh.use_mesh(mesh):
        with torch.no_grad():
            frozen, plain = count_collectives(
                lambda: llama.forward_train(local, args, tokens))
        for w in norms:
            w.requires_grad_(True)
        logits, recording = count_collectives(
            lambda: llama.forward_train(local, args, tokens))
        _, backward = count_collectives(lambda: logits.sum().backward())
    return {"no_grad": plain, "grad": recording, "backward": backward,
            "logits": (frozen, logits.detach()),
            "norm_grad": norms[-1].grad}


def generate_on_mesh(mesh, model, specs, prompts, images, gens):
    """``MetaModel.generate_tokens`` on this rank's shard of ``model``:
    the image prefill and the greedy decode over the split decoder."""
    model = copy.copy(model)
    model.params = pmesh.shard_params(model.params, mesh, specs)
    model.mesh = mesh
    return model.generate_tokens(prompts, images=images, max_gen_len=gens,
                                 temperature=0.0)


def two_rank_train_suite(mesh, cases, qlora, decoder, internlm):
    """On two ranks at model 2: every product's gradients, the QLoRA
    steps at data 1 x model 2, the decoder's collectives and the
    internlm_ems5_light prefill and decode."""
    out = {"products": {n: product_grads(mesh, c) for n, c in cases.items()}}
    out["qlora"], _ = qlora_steps(mesh, 2, *qlora)
    out["decoder"] = decoder_collectives(mesh, *decoder)
    out["internlm"] = generate_on_mesh(mesh, *internlm)
    return out
