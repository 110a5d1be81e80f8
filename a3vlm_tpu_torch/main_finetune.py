"""Training CLI of the port, on one device or on a ("data", "model") mesh
of ranks (counterpart of a3vlm_tpu/main_finetune.py; same flag surface).

    python -m a3vlm_tpu_torch.main_finetune --tokenizer_path TOK \\
        --data_config data.yaml --dialog --quant --quant_bits 4 \\
        --lora_rank 16 --only_save_trainable --checkpointing

The QLoRA recipe: the int4 (or int8) decoder base is frozen, the rank-r adapters on
the seven decoder linears, the decoder norms, the projectors and the image
tags train, with float32 masters under ``--precision bf16``. Data comes
from the port's copies of the JAX package's datasets, loader and sampler.
``--profile_dir`` (not ported yet) raises ``NotImplementedError`` naming
its ROADMAP item.

``--model_parallel_size`` above 1 or ``--num_devices`` above 1 trains on a
mesh of ranks, one process each (``parallel/launch.py``; the caller is
rank 0 and returns its ``TrainState``): over ``--devices`` (each rank's
device, ``cuda:0,cuda:0`` two ranks sharing a card; NCCL between cards,
gloo on the CPU or where ranks share a card), else over the first
``--num_devices`` visible cards (every one without it), or with
``--device cpu`` that many CPU ranks. Every rank builds the model from the
seed or the checkpoint, quantizes it with ``tp_align =
model_parallel_size * 128`` (the all-column int4 tree), makes the same
adapters, takes its shard (``train_partition_specs``) and runs the same
loop in lockstep over the global batch ``batch_size x data ranks``, each
data rank's loss on its rows (``train/step.py``). Rank 0 alone writes the
logs and the checkpoint files. ``--data_parallel`` is accepted with no
effect, as in the JAX CLI; the optimizer state takes the parameters'
shards (no ZeRO split: the JAX package has none).

``--llama_type`` takes what the JAX CLI trains: ``llama_ens5``,
``llama_ens5_2images`` (its loss takes a depth stream beside the RGB one,
which the CLI's datasets never load: a batch with images fails at its
first step, in both CLIs, and text-only data trains) and ``llama`` (a bare
decoder, whose loss reads the token ids alone). The JAX CLI fails on
``internlm_ems5_light`` and ``falcon`` once the model is built (it places
them with LLaMA's partition specs, which do not fit their trees); the
port refuses them with ``ValueError`` before loading anything.

Checkpoints go under ``--output_dir`` as the JAX CLI writes them
(``checkpoint/manager.py``: ``epoch_X`` every ``--save_interval`` epochs
and at the end, ``epoch_X-iter_Y`` every ``--save_iteration_interval``
updates, those asynchronously), with the per-epoch JSON lines in
``log.txt`` and TensorBoard scalars in ``tb/``. ``--resume auto`` (the
latest checkpoint under ``--output_dir``) or ``--resume DIR`` restores the
model, then the optimizer state, and goes on from the next update.
``--cache_tower_features`` runs the frozen towers once per image, in epoch
0 (``train/feature_cache.py``)."""

from __future__ import annotations

import argparse
import os
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from a3vlm_tpu_torch.models import llama as llama_mod
from a3vlm_tpu_torch.parallel.tp import Shard
from a3vlm_tpu_torch.quant import (
    QuantizedWeight,
    freeze_quantized_mask,
    tree_map,
)
from a3vlm_tpu_torch.train.lora import (
    attach_lora,
    attach_lora_into_model,
    init_lora_params,
    lora_base_trainable_mask,
)
from a3vlm_tpu_torch.train.losses import next_token_loss


def get_args_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        "A3VLM finetune (PyTorch, one device)", add_help=False)
    p.add_argument("--llama_type", default="llama_ens5")
    p.add_argument("--llama_config", nargs="*", default=None)
    p.add_argument("--tokenizer_path", required=True)
    p.add_argument("--pretrained_path", nargs="*", default=None)
    p.add_argument("--data_config", required=True)
    p.add_argument("--dialog", action="store_true")
    p.add_argument("--batch_size", type=int, default=2)
    p.add_argument("--accum_iter", type=int, default=1)
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--warmup_epochs", type=float, default=0.03)
    p.add_argument("--lr", type=float, default=2e-5)
    p.add_argument("--min_lr", type=float, default=0.0)
    p.add_argument("--weight_decay", type=float, default=0.0)
    p.add_argument("--clip_grad", type=float, default=8.0)
    p.add_argument("--max_words", type=int, default=2048)
    p.add_argument("--image_transform", default="padded_resize")
    p.add_argument("--input_size", type=int, default=448)
    p.add_argument("--model_parallel_size", type=int, default=1,
                   help="ranks a decoder linear splits over (the mesh's "
                   "\"model\" axis)")
    p.add_argument("--data_parallel", default="sdp",
                   choices=["sdp", "fsdp", "ddp"],
                   help="accepted with no effect, as in the JAX CLI")
    p.add_argument("--checkpointing", action="store_true",
                   help="activation checkpointing (per-block recompute)")
    p.add_argument("--precision", default="bf16", choices=["bf16", "fp32"])
    p.add_argument("--save_interval", type=int, default=1)
    p.add_argument("--save_iteration_interval", type=int, default=5000)
    p.add_argument("--only_save_trainable", action="store_true")
    p.add_argument("--cache_ann_on_disk", action="store_true")
    p.add_argument("--cache_tower_features", action="store_true",
                   help="compute the frozen vision towers once per image "
                   "(epoch 0) and replay the features afterwards "
                   "(train/feature_cache.py)")
    p.add_argument("--feature_cache_dir", default=None,
                   help="spill tower features to disk (default: RAM)")
    p.add_argument("--num_workers", type=int, default=0,
                   help="thread-pool item fetching inside each batch")
    p.add_argument("--lora_rank", type=int, default=0,
                   help="train rank-r LoRA adapters on the decoder linears "
                   "(their base weights freeze; norms, biases and "
                   "projectors keep training)")
    p.add_argument("--quant", action="store_true",
                   help="quantize the frozen decoder base to --quant_bits "
                   "before training (QLoRA); gradients flow through the "
                   "adapters and the dense trainables only")
    p.add_argument("--quant_bits", type=int, default=4, choices=[4, 8])
    p.add_argument("--output_dir", default="./output")
    p.add_argument("--resume", default="", help="'' | auto | ckpt dir")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--print_freq", type=int, default=10)
    p.add_argument("--num_devices", type=int, default=None,
                   help="ranks of the mesh (the first N visible cards, or "
                   "N CPU ranks with --device cpu)")
    p.add_argument("--devices", default=None,
                   help="comma-separated device of each rank, e.g. "
                   "cuda:0,cuda:1 or cpu,cpu (cuda:0,cuda:0: two ranks "
                   "on one card)")
    p.add_argument("--tiny_random_model", action="store_true")
    p.add_argument("--profile_dir", default=None, help="not ported yet")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu for tests); "
                   "with --num_devices or --model_parallel_size the kind "
                   "of the ranks' devices")
    return p


# the types the JAX CLI trains: the ens5 families (``is_ens``,
# main_finetune.py:216) and the bare LLaMA decoder
TRAINED_TYPES = ("llama_ens5", "llama_ens5_2images", "llama")


def _is_ens(llama_type: str) -> bool:
    return llama_type.startswith("llama_ens5")


def _refuse_unported(args) -> None:
    if args.profile_dir:
        raise NotImplementedError("--profile_dir is not ported yet (ROADMAP "
                                  "Queue 1 item 6, the benchmark's "
                                  "tracing)")
    if args.llama_type not in TRAINED_TYPES and not args.tiny_random_model:
        # the JAX CLI builds the model, then fails placing it:
        # llama_partition_specs (main_finetune.py:364-368) does not fit
        # this family's tree
        raise ValueError(f"main_finetune does not train llama_type "
                         f"{args.llama_type}: the JAX CLI trains "
                         f"{', '.join(TRAINED_TYPES)}")
    if args.quant and not args.only_save_trainable:
        raise ValueError("--only_save_trainable is required with --quant")
    if (args.cache_tower_features and not args.tiny_random_model
            and not _is_ens(args.llama_type)):
        raise ValueError("--cache_tower_features is ens5-family only")


def build_model(args, tokenizer):
    from a3vlm_tpu_torch.config import tiny_ens5_config
    from a3vlm_tpu_torch.meta import MetaModel

    dtype = torch.bfloat16 if args.precision == "bf16" else torch.float32
    if args.pretrained_path and not args.tiny_random_model:
        # (main_finetune.py:108-117) the towers come from the checkpoint or,
        # when it holds the decoder alone, at random from the seed
        return MetaModel.from_pretrained(
            args.pretrained_path, llama_type=args.llama_type,
            llama_config=args.llama_config, tokenizer=tokenizer,
            with_visual=True, max_seq_len=args.max_words, dtype=dtype,
            device=args.device)
    if args.tiny_random_model:
        # (main_finetune.py:96-106) a tiny llama_ens5 whatever the type
        return MetaModel("llama_ens5", with_visual=True,
                         max_seq_len=args.max_words, dtype=dtype,
                         tokenizer=tokenizer, model_cfg=tiny_ens5_config(),
                         seed=args.seed, device=args.device)
    return MetaModel(args.llama_type, llama_config=args.llama_config,
                     with_visual=True, max_seq_len=args.max_words,
                     dtype=dtype, tokenizer=tokenizer, seed=args.seed,
                     device=args.device)


def qlora_trainable_mask(model, lora=None, quant: bool = False) -> dict:
    """The trainable mask of the recipe (main_finetune.py:216-283): the
    model's mask (the ens5 towers frozen), packed bases frozen, and with
    adapters the decoder reduced to its norms and biases (for a bare
    decoder, the whole tree) plus every adapter leaf."""
    mask = model.get_trainable_params()
    if quant:
        mask = freeze_quantized_mask(model.params, mask)
    if lora is not None:
        base = lora_base_trainable_mask(model.decoder)
        mask = ({**mask, "llama": base} if _is_ens(model.llama_type)
                else base)
        mask = {**mask, "lora": tree_map(lambda _: True, lora)}
    return mask


def make_loss_fn(model, compute_dtype: torch.dtype, remat: bool,
                 impl: str = "auto") -> Callable:
    """``loss_fn(params, batch)`` of the recipe (main_finetune.py:303):
    float32 leaves are cast to ``compute_dtype`` inside the loss, so the
    gradients land on the float32 masters; packed bases pass untouched;
    a ``"lora"`` subtree is attached to the decoder. The ens5 families
    take the batch's images or cached tower features (``image_feat_q`` /
    ``image_feat_ens``), ``llama_ens5_2images`` its depth stream too
    (``depth_image`` or ``depth_feat_q`` / ``depth_feat_ens``); a bare
    ``llama`` decoder reads the token ids alone. Inside ``use_mesh`` of a
    mesh with several data ranks every rank passes the whole batch and the
    loss takes this rank's rows (``meta.data_local_batch``: the towers on
    the whole batch, crop-split) and returns the whole batch's mean."""
    from a3vlm_tpu_torch.meta import data_local_batch
    from a3vlm_tpu_torch.parallel.mesh import current_mesh

    is_ens = _is_ens(model.llama_type)

    def cast(p):
        if isinstance(p, Shard):  # a rank's block: cast the block
            return p.with_local(cast(p.local))
        if isinstance(p, QuantizedWeight) or p.dtype != torch.float32:
            return p
        return p.to(compute_dtype)

    def loss_fn(params, batch):
        mesh = current_mesh()
        data_mesh = None
        if mesh is not None and mesh.dp_size > 1:
            batch = data_local_batch(model.llama_type, params, model.cfg,
                                     batch, "plain" if impl == "plain"
                                     else "auto")
            if batch is None:
                raise ValueError(f"the batch does not split over "
                                 f"{mesh.dp_size} data ranks")
            data_mesh = mesh
        if compute_dtype != torch.float32:
            params = tree_map(cast, params)
        if "lora" in params:
            lora = params["lora"]
            params = {k: v for k, v in params.items() if k != "lora"}
            params = (attach_lora_into_model(params, lora) if is_ens
                      else attach_lora(params, lora))
        if not is_ens:
            logits = llama_mod.forward_train(params, model.cfg,
                                             batch["examples"], remat=remat,
                                             impl=impl)
            return next_token_loss(logits, batch["labels"],
                                   vocab_size=model.true_vocab,
                                   data_mesh=data_mesh)
        imf = None
        if "image_feat_q" in batch:
            imf = {"q": batch["image_feat_q"], "ens": batch["image_feat_ens"]}
        kwargs = {}
        if model.llama_type == "llama_ens5_2images":
            # the 2-images forward takes both streams, raw or cached
            kwargs["depth_image"] = batch.get("depth_image")
            if "depth_feat_q" in batch:
                kwargs["depth_features"] = {"q": batch["depth_feat_q"],
                                            "ens": batch["depth_feat_ens"]}
        logits = model._mod.forward(params, model.cfg, batch["examples"],
                                    image=batch.get("image"), remat=remat,
                                    impl=impl, image_features=imf, **kwargs)
        return next_token_loss(logits, batch["labels"],
                               vocab_size=model.true_vocab,
                               data_mesh=data_mesh)

    return loss_fn


def batch_to_device(batch: dict, device, image_dtype: torch.dtype) -> dict:
    """Loader batch -> tensors on ``device``: token ids as int64, images
    (RGB and depth) in the towers' dtype, cached tower features in their
    own."""
    out = {}
    for k in ("examples", "labels", "image", "depth_image"):
        if k in batch:
            t = torch.from_numpy(np.asarray(batch[k])).to(device)
            out[k] = t.long() if k in ("examples", "labels") \
                else t.to(image_dtype)
    for k in ("image_feat_q", "image_feat_ens", "depth_feat_q",
              "depth_feat_ens"):
        if k in batch:
            out[k] = batch[k].to(device)
    return out


def mesh_devices(args) -> list[str]:
    """Each rank's device: ``--devices``; else one, ``--device``, unless
    ``--num_devices`` or ``--model_parallel_size`` asks for more: then the
    first ``--num_devices`` visible cards (every one without it), or that
    many CPU ranks (``--model_parallel_size`` of them without it) with
    ``--device cpu``."""
    from a3vlm_tpu_torch.parallel.mesh import visible_devices

    mp, n = args.model_parallel_size, args.num_devices
    if args.devices:
        devices = [d.strip() for d in args.devices.split(",") if d.strip()]
        if n and n != len(devices):
            raise ValueError(f"--num_devices {n} but --devices names "
                             f"{len(devices)}")
    elif mp == 1 and (n or 1) == 1:
        devices = [args.device]
    elif torch.device(args.device).type == "cpu":
        devices = ["cpu"] * (n or mp)
    else:
        devices = visible_devices()
        if n:
            if n > len(devices):
                raise ValueError(f"--num_devices {n}: {len(devices)} cards "
                                 "are visible")
            devices = devices[:n]
    if len(devices) % mp:
        raise ValueError(f"device count {len(devices)} not divisible by "
                         f"model_parallel_size {mp}")
    return devices


def train_partition_specs(model, lora, model_parallel_size: int) -> dict:
    """The specs of the trained tree on a mesh (main_finetune.py:364-385):
    the family's dense specs, ``quantized_partition_specs`` over a packed
    decoder, and ``lora_partition_specs`` for the adapters."""
    from a3vlm_tpu_torch.models import ens5 as ens5_mod
    from a3vlm_tpu_torch.quant import quantized_partition_specs
    from a3vlm_tpu_torch.train.lora import lora_partition_specs

    leaves: list = []
    tree_map(leaves.append, model.decoder)
    quantized = any(isinstance(x, QuantizedWeight) for x in leaves)
    if _is_ens(model.llama_type):
        specs = ens5_mod.ens5_partition_specs(model.cfg, model.params)
        if quantized:
            specs["llama"] = quantized_partition_specs(
                specs["llama"], model.params["llama"], model_parallel_size)
    else:
        specs = llama_mod.llama_partition_specs(model.args)
        if quantized:
            specs = quantized_partition_specs(specs, model.params,
                                              model_parallel_size)
    if lora is not None:
        specs = {**specs, "lora": lora_partition_specs(lora)}
    return specs


def main(argv=None, tokenizer=None):
    """The CLI (main_finetune.py:157). ``tokenizer``: an object with the
    tokenizer surface to use in place of ``--tokenizer_path`` (which is
    then not read). Returns the final ``TrainState`` (rank 0's on a
    mesh)."""
    return train(argv, tokenizer)[0]


def train(argv=None, tokenizer=None, rank_report=None):
    """``main``, returning (rank 0's ``TrainState``, every rank's report
    in rank order): ``steps`` (each update's loss, grad norm and wall
    seconds), ``peak_gib`` (the card's peak allocated memory; None on the
    CPU), ``replicas`` (the digest of the replicated trainables, which
    must be every rank's) and, with ``rank_report``, what that function
    (picklable, of no arguments) returns, called on each rank after
    training."""
    args = get_args_parser().parse_args(argv)
    print(f"args: {args}")
    _refuse_unported(args)
    devices = mesh_devices(args)
    if len(devices) == 1:
        out = [_train_rank(None, args, tokenizer, rank_report)]
    else:
        from a3vlm_tpu_torch.parallel.launch import run_spmd

        print(f"mesh: {len(devices)} ranks on {devices}, model "
              f"{args.model_parallel_size}")
        out = run_spmd(_train_rank, devices, args, tokenizer, rank_report,
                       model_parallel_size=args.model_parallel_size)
    reports = [o["report"] for o in out]
    if len({r["replicas"] for r in reports}) != 1:
        raise RuntimeError("replicated trainables differ across ranks")
    return out[0]["state"], reports


def _train_rank(mesh, args, tokenizer, rank_report):
    """One rank of ``train`` (all of it on one device, ``mesh`` None); the
    ranks other than 0 print nothing and return no state."""
    import contextlib
    import io

    from a3vlm_tpu_torch.parallel.mesh import is_parallel

    mesh = mesh if is_parallel(mesh) else None
    lead = mesh is None or mesh.rank == 0
    if mesh is not None:
        args = argparse.Namespace(**{**vars(args),
                                     "device": str(mesh.device)})
    quiet = contextlib.nullcontext() if lead else \
        contextlib.redirect_stdout(io.StringIO())
    with quiet:
        state, steps, digest = _fit(args, tokenizer, mesh, lead)
    cuda = torch.device(args.device).type == "cuda"
    report = {"rank": mesh.rank if mesh else 0, "steps": steps,
              "peak_gib": (torch.cuda.max_memory_allocated() / 2**30
                           if cuda else None),
              "replicas": digest}
    if rank_report is not None:
        report.update(rank_report())
    return {"state": state if lead else None, "report": report}


def _fit(args, tokenizer, mesh, lead: bool):
    """Build, shard and train on this rank (the body of the JAX CLI's
    ``main``). Returns (state, each update's metrics, the replicated
    trainables' digest)."""
    import time

    from a3vlm_tpu_torch.checkpoint.manager import (
        CheckpointManager,
        find_latest_checkpoint,
    )
    from a3vlm_tpu_torch.data.alpaca import FinetuneDataset
    from a3vlm_tpu_torch.data.dialog import FinetuneDialogDataset
    from a3vlm_tpu_torch.data.loader import DataLoader
    from a3vlm_tpu_torch.data.sampler import FinetuneDistSampler
    from a3vlm_tpu_torch.data.transforms import get_transform
    from a3vlm_tpu_torch.parallel.mesh import (
        barrier,
        broadcast_object,
        shard_params,
        use_mesh,
    )
    from a3vlm_tpu_torch.tokenizer import Tokenizer
    from a3vlm_tpu_torch.train.engine import train_one_epoch
    from a3vlm_tpu_torch.train.lr_sched import make_epoch_schedule
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
        partition_params,
        replica_digest,
    )
    from a3vlm_tpu_torch.utils.logging import JsonlLogger, TensorBoardLogger
    from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    device = torch.device(args.device)
    mp = args.model_parallel_size
    dp = mesh.dp_size if mesh is not None else 1
    if mesh is not None:
        print(f"mesh: data={dp} model={mp} ({mesh.backend})")

    if tokenizer is None:
        tokenizer = Tokenizer(args.tokenizer_path)
    model = build_model(args, tokenizer)
    if args.quant:
        # (main_finetune.py:179-185) the ffn hidden dim padded so the gate
        # / up shards stay lane-aligned: the all-column int4 tree
        model.quantize(bits=args.quant_bits,
                       tp_align=mp * 128 if mp > 1 else 0)
        print(f"quantized decoder base to int{args.quant_bits}")

    dataset = (FinetuneDialogDataset if args.dialog else FinetuneDataset)(
        args.data_config,
        transform=get_transform(args.image_transform, getattr(
            model.cfg, "image_size", args.input_size)),
        max_words=args.max_words, image_words=model.get_image_words(),
        tokenizer=model.tokenizer, cache_on_disk=args.cache_ann_on_disk,
    )
    # (main_finetune.py:203) one sampler over the global batch on every
    # rank; each data rank's loss takes its rows
    global_bs = args.batch_size * dp
    sampler = FinetuneDistSampler(
        dataset, num_replicas=1, rank=0, batch_size=global_bs,
        acc_grad=args.accum_iter, seed=args.seed)
    loader = DataLoader(dataset, sampler, batch_size=global_bs,
                        accum_steps=args.accum_iter,
                        workers=args.num_workers,
                        with_indices=args.cache_tower_features)

    lora = None
    if args.lora_rank > 0:
        # made whole from the seed on every rank, then sliced: a mesh run
        # starts from the one-device run's adapters
        gen = torch.Generator(device=device).manual_seed(args.seed + 17)
        lora = init_lora_params(gen, model.decoder, rank=args.lora_rank)
        print(f"lora rank {args.lora_rank} on the decoder linears")
    trainable = qlora_trainable_mask(model, lora, quant=args.quant)
    compute_dtype = (torch.bfloat16 if args.precision == "bf16"
                     else torch.float32)
    if args.precision == "bf16":
        # float32 masters for the trainables, bf16 for the frozen rest; the
        # JAX CLI casts before narrowing the decoder to its norms, which
        # leaves frozen embeddings in float32 with the same loss
        model.params = mixed_precision_policy(model.params, trainable,
                                              compute_dtype)
    params = {**model.params, "lora": lora} if lora is not None \
        else model.params
    if mesh is not None:
        # (main_finetune.py:364-385) each rank keeps its shard
        params = shard_params(params, mesh,
                              train_partition_specs(model, lora, mp))
        model.params = {k: v for k, v in params.items() if k != "lora"}
        model.mesh = mesh
    if args.cache_tower_features:
        from a3vlm_tpu_torch.train.feature_cache import (
            FeatureCachingLoader,
            TowerFeatureCache,
        )

        cache_dir = args.feature_cache_dir
        if cache_dir and mesh is not None:
            # every rank caches the whole batch's features: a directory
            # each
            cache_dir = os.path.join(cache_dir, f"rank_{mesh.rank}")
        depth_cache = None
        if model.llama_type == "llama_ens5_2images":
            # the depth stream runs the same frozen towers: a cache of its
            # own (its indices are the RGB stream's)
            depth_cache = TowerFeatureCache(
                model.params, model.cfg,
                cache_dir=os.path.join(cache_dir, "depth")
                if cache_dir else None)
        loader = FeatureCachingLoader(loader, TowerFeatureCache(
            model.params, model.cfg, cache_dir=cache_dir),
            depth_cache=depth_cache)
        print("tower-feature cache on: towers run once per image, "
              "later epochs are tower-free")

    schedule = make_epoch_schedule(
        lr=args.lr, min_lr=args.min_lr, warmup_epochs=args.warmup_epochs,
        epochs=args.epochs, updates_per_epoch=max(len(loader), 1))
    optimizer = make_optimizer(schedule, max_grad_norm=args.clip_grad,
                               weight_decay=args.weight_decay)
    train_step = make_train_step(
        make_loss_fn(model, compute_dtype, remat=args.checkpointing),
        optimizer, accum_steps=args.accum_iter, trainable_mask=trainable,
        mesh=mesh)
    # the moments take the parameters' shards
    state = TrainState.create(params, optimizer, trainable)

    ckpt_mgr = CheckpointManager(args.output_dir, mesh=mesh)
    tb = TensorBoardLogger(str(Path(args.output_dir) / "tb")) if lead \
        else None
    jsonl = JsonlLogger(args.output_dir) if lead else None

    start_epoch, start_iter = 0, 0
    resume_dir = (find_latest_checkpoint(args.output_dir)
                  if args.resume == "auto" else args.resume or None)
    if mesh is not None:
        # rank 0's reading of the directory: every rank resumes from it
        resume_dir = broadcast_object(resume_dir, mesh)
    if resume_dir:
        # (main_finetune.py:399-419) the model, then the optimizer state;
        # the step counter is not restored, as in the JAX CLI: the
        # schedule reads the optimizer's count
        print(f"resuming from {resume_dir}")
        state.params = ckpt_mgr.restore_params(resume_dir, state.params)
        extra = ckpt_mgr.restore_train_state(resume_dir, state.opt_state)
        if "opt_state" in extra:
            state.opt_state = extra["opt_state"]
        start_epoch = extra.get("epoch", 0)
        start_iter = extra.get("iter", 0)
        if start_iter == 0:
            start_epoch += 1

    def save_fn(state, epoch, it=None):
        ckpt_mgr.save(
            epoch, it, params=state.params, opt_state=state.opt_state,
            step=state.step,
            dataset_state={"epoch": epoch, "start_iter": it or 0},
            tokenizer=model.tokenizer, llama_type=model.llama_type,
            llama_config={"max_seq_len": args.max_words},
            trainable_mask=trainable if args.only_save_trainable else None,
            # in-epoch saves are asynchronous: training goes on while the
            # files are written; finalized by the next save or the barrier
            # below
            wait=it is None)

    steps: list = []

    def stepper(st, b):
        t0 = time.perf_counter()
        st, metrics = train_step(st, batch_to_device(b, device,
                                                     compute_dtype))
        steps.append({"loss": float(metrics["loss"]),
                      "grad_norm": float(metrics["grad_norm"]),
                      "seconds": time.perf_counter() - t0})
        return st, metrics

    if mesh is not None:
        # every rank built and placed its model (its card done with it):
        # the first update's time is its own, not the slowest rank's start
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        barrier(mesh)
    try:
        # the towers of a feature cache split their crops over the mesh too
        with use_mesh(mesh):
            for epoch in range(start_epoch, args.epochs):
                sampler.set_epoch(epoch,
                                  start_iter if epoch == start_epoch else 0)
                state, stats = train_one_epoch(
                    stepper, state, loader, epoch, lr=args.lr,
                    min_lr=args.min_lr, warmup_epochs=args.warmup_epochs,
                    epochs=args.epochs, print_freq=args.print_freq,
                    tb_logger=tb, save_fn=save_fn,
                    save_iteration_interval=args.save_iteration_interval)
                if ((epoch + 1) % args.save_interval == 0
                        or epoch + 1 == args.epochs):
                    save_fn(state, epoch)
                if jsonl is not None:
                    jsonl.write({"epoch": epoch, **stats})
    except BaseException:
        # finalize an in-epoch save even on an error, so a checkpoint that
        # was written whole gets its _DONE (no barrier: the other ranks
        # may be waiting in a collective this rank left)
        ckpt_mgr.wait_until_finished(barrier=False)
        raise
    finally:
        if tb is not None:
            tb.flush()
    ckpt_mgr.wait_until_finished()
    print("training done")
    return (state, steps,
            replica_digest(partition_params(state.params, trainable)[0]))


if __name__ == "__main__":
    main()
