"""Training CLI of the port, on one device (counterpart of
a3vlm_tpu/main_finetune.py; same flag surface).

    python -m a3vlm_tpu_torch.main_finetune --tokenizer_path TOK \\
        --data_config data.yaml --dialog --quant --quant_bits 4 \\
        --lora_rank 16 --only_save_trainable --checkpointing

The QLoRA recipe: the int4 (or int8) decoder base is frozen, the rank-r adapters on
the seven decoder linears, the decoder norms, the projectors and the image
tags train, with float32 masters under ``--precision bf16``. Data comes
from the port's copies of the JAX package's datasets, loader and sampler.
The flags of parts not ported yet raise ``NotImplementedError`` naming
their ROADMAP item.

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
from pathlib import Path
from typing import Callable

import numpy as np
import torch

from a3vlm_tpu_torch.models import ens5 as ens5_mod
from a3vlm_tpu_torch.quant import (
    QuantizedWeight,
    freeze_quantized_mask,
    tree_map,
)
from a3vlm_tpu_torch.train.lora import (
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
                   help="only 1: one device")
    p.add_argument("--data_parallel", default="sdp",
                   choices=["sdp", "fsdp", "ddp"],
                   help="no effect on one device")
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
                   help="only 1: one device")
    p.add_argument("--tiny_random_model", action="store_true")
    p.add_argument("--profile_dir", default=None, help="not ported yet")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd anomaly detection")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (cuda, or cpu for tests)")
    return p


def _refuse_unported(args) -> None:
    unported = [
        (args.model_parallel_size > 1 or (args.num_devices or 1) > 1,
         "more than one device", "Queue 1 item 17"),
        (args.llama_type != "llama_ens5", f"llama_type {args.llama_type}",
         "Queue 1 item 15"),
        (bool(args.profile_dir), "--profile_dir",
         "Queue 1 item 6 (the benchmark's tracing)"),
    ]
    for hit, what, item in unported:
        if hit:
            raise NotImplementedError(f"{what} is not ported yet (ROADMAP "
                                      f"{item})")
    if args.quant and not args.only_save_trainable:
        raise ValueError("--only_save_trainable is required with --quant")


def build_model(args, tokenizer):
    from a3vlm_tpu_torch.config import (
        Ens5Config,
        ModelArgs,
        model_args_from_json,
        tiny_ens5_config,
    )
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
        cfg = tiny_ens5_config()
    elif args.llama_config:
        cfg = Ens5Config(llama=model_args_from_json(
            args.llama_config, max_seq_len=args.max_words))
    else:
        cfg = Ens5Config(llama=ModelArgs(max_seq_len=args.max_words))
    return MetaModel("llama_ens5", with_visual=True,
                     max_seq_len=args.max_words, dtype=dtype,
                     tokenizer=tokenizer, model_cfg=cfg, seed=args.seed,
                     device=args.device)


def qlora_trainable_mask(model, lora=None, quant: bool = False) -> dict:
    """The trainable mask of the recipe (main_finetune.py:216-283): the
    ens5 mask (towers frozen), packed bases frozen, and with adapters the
    decoder reduced to its norms and biases plus every adapter leaf."""
    mask = model.get_trainable_params()
    if quant:
        mask = freeze_quantized_mask(model.params, mask)
    if lora is not None:
        mask = {**mask,
                "llama": lora_base_trainable_mask(model.params["llama"]),
                "lora": tree_map(lambda _: True, lora)}
    return mask


def make_loss_fn(model, compute_dtype: torch.dtype, remat: bool,
                 impl: str = "auto") -> Callable:
    """``loss_fn(params, batch)`` of the recipe (main_finetune.py:303):
    float32 leaves are cast to ``compute_dtype`` inside the loss, so the
    gradients land on the float32 masters; packed bases pass untouched;
    a ``"lora"`` subtree is attached to the decoder; cached tower features
    (``image_feat_q`` / ``image_feat_ens``) stand in for the image."""

    def cast(p):
        if isinstance(p, QuantizedWeight) or p.dtype != torch.float32:
            return p
        return p.to(compute_dtype)

    def loss_fn(params, batch):
        if compute_dtype != torch.float32:
            params = tree_map(cast, params)
        if "lora" in params:
            lora = params["lora"]
            params = attach_lora_into_model(
                {k: v for k, v in params.items() if k != "lora"}, lora)
        imf = None
        if "image_feat_q" in batch:
            imf = {"q": batch["image_feat_q"], "ens": batch["image_feat_ens"]}
        logits = ens5_mod.forward(params, model.cfg, batch["examples"],
                                  image=batch.get("image"), remat=remat,
                                  impl=impl, image_features=imf)
        return next_token_loss(logits, batch["labels"],
                               vocab_size=model.true_vocab)

    return loss_fn


def batch_to_device(batch: dict, device, image_dtype: torch.dtype) -> dict:
    """Loader batch -> tensors on ``device``: token ids as int64, images in
    the towers' dtype, cached tower features in their own."""
    out = {}
    for k in ("examples", "labels", "image"):
        if k in batch:
            t = torch.from_numpy(np.asarray(batch[k])).to(device)
            out[k] = t.to(image_dtype) if k == "image" else t.long()
    for k in ("image_feat_q", "image_feat_ens"):
        if k in batch:
            out[k] = batch[k].to(device)
    return out


def main(argv=None, tokenizer=None):
    """The CLI (main_finetune.py:157). ``tokenizer``: an object with the
    tokenizer surface to use in place of ``--tokenizer_path`` (which is
    then not read). Returns the final ``TrainState``."""
    from a3vlm_tpu_torch.checkpoint.manager import (
        CheckpointManager,
        find_latest_checkpoint,
    )
    from a3vlm_tpu_torch.data.alpaca import FinetuneDataset
    from a3vlm_tpu_torch.data.dialog import FinetuneDialogDataset
    from a3vlm_tpu_torch.data.loader import DataLoader
    from a3vlm_tpu_torch.data.sampler import FinetuneDistSampler
    from a3vlm_tpu_torch.data.transforms import get_transform
    from a3vlm_tpu_torch.tokenizer import Tokenizer
    from a3vlm_tpu_torch.train.engine import train_one_epoch
    from a3vlm_tpu_torch.train.lr_sched import make_epoch_schedule
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from a3vlm_tpu_torch.utils.logging import JsonlLogger, TensorBoardLogger
    from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

    args = get_args_parser().parse_args(argv)
    print(f"args: {args}")
    _refuse_unported(args)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)
    device = torch.device(args.device)

    if tokenizer is None:
        tokenizer = Tokenizer(args.tokenizer_path)
    model = build_model(args, tokenizer)
    if args.quant:
        model.quantize(bits=args.quant_bits)
        print(f"quantized decoder base to int{args.quant_bits}")

    dataset = (FinetuneDialogDataset if args.dialog else FinetuneDataset)(
        args.data_config,
        transform=get_transform(args.image_transform, model.cfg.image_size),
        max_words=args.max_words, image_words=model.get_image_words(),
        tokenizer=model.tokenizer, cache_on_disk=args.cache_ann_on_disk,
    )
    sampler = FinetuneDistSampler(
        dataset, num_replicas=1, rank=0, batch_size=args.batch_size,
        acc_grad=args.accum_iter, seed=args.seed)
    loader = DataLoader(dataset, sampler, batch_size=args.batch_size,
                        accum_steps=args.accum_iter,
                        workers=args.num_workers,
                        with_indices=args.cache_tower_features)

    lora = None
    if args.lora_rank > 0:
        gen = torch.Generator(device=device).manual_seed(args.seed + 17)
        lora = init_lora_params(gen, model.params["llama"],
                                rank=args.lora_rank)
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
    if args.cache_tower_features:
        from a3vlm_tpu_torch.train.feature_cache import (
            FeatureCachingLoader,
            TowerFeatureCache,
        )

        loader = FeatureCachingLoader(loader, TowerFeatureCache(
            model.params, model.cfg, cache_dir=args.feature_cache_dir))
        print("tower-feature cache on: towers run once per image, "
              "later epochs are tower-free")
    params = {**model.params, "lora": lora} if lora is not None \
        else model.params

    schedule = make_epoch_schedule(
        lr=args.lr, min_lr=args.min_lr, warmup_epochs=args.warmup_epochs,
        epochs=args.epochs, updates_per_epoch=max(len(loader), 1))
    optimizer = make_optimizer(schedule, max_grad_norm=args.clip_grad,
                               weight_decay=args.weight_decay)
    train_step = make_train_step(
        make_loss_fn(model, compute_dtype, remat=args.checkpointing),
        optimizer, accum_steps=args.accum_iter, trainable_mask=trainable)
    state = TrainState.create(params, optimizer, trainable)

    ckpt_mgr = CheckpointManager(args.output_dir)
    tb = TensorBoardLogger(str(Path(args.output_dir) / "tb"))
    jsonl = JsonlLogger(args.output_dir)

    start_epoch, start_iter = 0, 0
    resume_dir = (find_latest_checkpoint(args.output_dir)
                  if args.resume == "auto" else args.resume or None)
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

    try:
        for epoch in range(start_epoch, args.epochs):
            sampler.set_epoch(epoch,
                              start_iter if epoch == start_epoch else 0)
            state, stats = train_one_epoch(
                lambda st, b: train_step(st, batch_to_device(
                    b, device, compute_dtype)),
                state, loader, epoch, lr=args.lr, min_lr=args.min_lr,
                warmup_epochs=args.warmup_epochs, epochs=args.epochs,
                print_freq=args.print_freq, tb_logger=tb, save_fn=save_fn,
                save_iteration_interval=args.save_iteration_interval)
            if ((epoch + 1) % args.save_interval == 0
                    or epoch + 1 == args.epochs):
                save_fn(state, epoch)
            jsonl.write({"epoch": epoch, **stats})
    finally:
        # finalize an in-epoch save even on an error, so a checkpoint that
        # was written whole gets its _DONE
        ckpt_mgr.wait_until_finished()
        tb.flush()
    print("training done")
    return state


if __name__ == "__main__":
    main()
