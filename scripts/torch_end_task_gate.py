"""Closed-loop end-task gates of the PyTorch port: the accuracy gate of
tests/test_accuracy_gate.py and the A8 end-task gate of
scripts/quant_end_task_gate.py, run through ``a3vlm_tpu_torch`` alone.

Pipeline: datagen renders one synthetic articulated object (a box with a
hinged lid) -> the labeler writes its VQA task files -> a small
``llama_ens5`` is trained until it memorizes the triads of four of them
(2D box, 2D joint, 3D box, 3D joint) -> ``ModelServer.generate`` answers
the same questions greedily through the eval path's prompts -> the
production codecs parse the answers -> rotated IoU, joint types, 3D corner
distances, exact OBB IoU and axis angles against the ground truth.

The accuracy gate holds the JAX gate's thresholds: 2D box mean IoU >= 0.6;
joint mean IoU >= 0.6 and every joint type right; 3D median corner
distance <= 0.1, median OBB IoU >= 0.5, at least half the corner distances
<= 0.1; every 3D joint type right and median axis angle <= 10 degrees.
The A8 gate scores the 2D box mean IoU and the 3D mean OBB IoU of the same
model four ways (dense; int4; int4 with W4A8 decode; int4 with W8A8
prefill) and fails where an A8 mode falls more than ``--tol`` below int4.

On the CPU (``--device cpu``) the model is ``tiny_ens5_config`` in float32,
as in the JAX gate. On the card the decoder and towers are widened to the
smallest shapes that every kernel takes (``card_config``), AdamW's rate
scaled to the decoder's width (``gate_lr``), and training runs bf16
compute over float32 masters; the model is served in bf16.

    python scripts/torch_end_task_gate.py [--device cuda] [--max_epochs 400]
        [--tol 0.05]

Prints one JSON line of results and verdicts and exits non-zero when a
gate fails. ``chip_smoke.py`` phase 13 runs the same functions.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import random
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# The synthetic object (tests/test_datagen_pipeline.py's): a 1 m box with
# a 1 m x 1 m lid hinged on one edge.
URDF_XML = """<?xml version="1.0"?>
<robot name="box_object">
  <link name="link_0">
    <visual><geometry><box size="1 1 1"/></geometry></visual>
    <collision><geometry><box size="1 1 1"/></geometry></collision>
  </link>
  <link name="link_1">
    <visual><origin xyz="0 0.5 0.1"/><geometry><box size="1 1 0.2"/></geometry></visual>
    <collision><origin xyz="0 0.5 0.1"/><geometry><box size="1 1 0.2"/></geometry></collision>
  </link>
  <joint name="joint_1" type="revolute">
    <origin xyz="0 -0.5 0.5"/>
    <axis xyz="1 0 0"/>
    <parent link="link_0"/>
    <child link="link_1"/>
    <limit lower="0" upper="1.2"/>
  </joint>
</robot>
"""

MOBILITY_V2 = [
    {"id": 0, "parent": -1, "joint": "heavy", "name": "box_body",
     "jointData": {}},
    {"id": 1, "parent": 0, "joint": "hinge", "name": "rotation_lid",
     "jointData": {"axis": {"origin": [0.5, 0.0, -0.5],
                            "direction": [0.0, 0.0, -1.0]}}},
]

SEMANTICS = "link_0 heavy box_body\nlink_1 hinge rotation_lid\n"

# the gate corpus's camera: 192 px
CAMERA_INFO = {
    "fx": 200.0, "fy": 200.0, "cx": 96.0, "cy": 96.0,
    "width": 192, "height": 192,
}

# the JAX gate's thresholds (tests/test_accuracy_gate.py)
MIN_MEAN_IOU_2D = 0.6
MAX_MEDIAN_CORNER_DIST = 0.1
MIN_MEDIAN_OBB_IOU = 0.5
MAX_MEDIAN_AXIS_DEG = 10.0
# training: the epoch's largest batch loss ends it below STOP_LOSS; the
# model must end below FINAL_LOSS (tests/test_accuracy_gate.py:112-133)
STOP_LOSS = 0.002
FINAL_LOSS = 0.03
# AdamW's learning rate at the JAX gate's decoder width (64); a wider
# decoder takes it scaled by 64 / dim (Adam's update is the same size
# whatever a weight's fan-in, so a wider layer's output moves that much
# more a step): at dim 128 and 256 the unscaled rate left the epoch's
# largest batch loss swinging between 0.003 and 0.6 for 400 epochs
# (scripts/torch_gate_train_sweep.py)
LR_AT_DIM_64 = 2e-3
MAX_GEN_2D = 48
MAX_GEN_3D = 170  # 8-corner answers are ~141 tiny-BPE tokens


def build_tokenizer(tmp: str) -> str:
    """The test suite's tiny LLaMA-ish BPE tokenizer (tests/conftest.py),
    trained on the triad and conversation vocabulary; saved under
    ``tmp/tok``."""
    from tokenizers import Tokenizer as HFTok
    from tokenizers import decoders, models, pre_tokenizers, trainers
    from transformers import PreTrainedTokenizerFast

    corpus = [
        "A chat between a curious human and an artificial intelligence "
        "assistant. The assistant gives helpful, detailed, and polite "
        "answers to the human's questions.",
        "### Human: Assistant: please provide the joint's type and its 2D "
        "rotated bounding box linked to the object part door drawer lid",
        "<rb>revolute</rb><rbd></rbd><box></box><axis>prismatic</axis>",
        "[0.12,0.34,0.56,0.78,0.90] the answer is Opened Closed",
        "0123456789 .,[]<>/# Hi my darling detect all manipulable object "
        "parts and provide their rotated bounding boxes",
        "There are two manipulable object parts with their 3d bounding "
        "boxes slide_open flap_close StatusComplete",
    ] * 50
    tok = HFTok(models.BPE(unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Metaspace()
    tok.decoder = decoders.Metaspace()
    trainer = trainers.BpeTrainer(
        vocab_size=800, special_tokens=["<unk>", "<s>", "</s>"]
    )
    tok.train_from_iterator(corpus, trainer)
    fast = PreTrainedTokenizerFast(
        tokenizer_object=tok, unk_token="<unk>", bos_token="<s>",
        eos_token="</s>",
    )
    d = os.path.join(tmp, "tok")
    fast.save_pretrained(d)
    return d


def write_object(data_dir: str, obj_id: str = "101") -> None:
    """The synthetic object's PartNet-Mobility files under
    ``data_dir/obj_id``."""
    obj = os.path.join(data_dir, obj_id)
    os.makedirs(obj)
    with open(os.path.join(obj, "mobility.urdf"), "w") as f:
        f.write(URDF_XML)
    with open(os.path.join(obj, "meta.json"), "w") as f:
        json.dump({"model_cat": "Box"}, f)
    with open(os.path.join(obj, "semantics.txt"), "w") as f:
        f.write(SEMANTICS)
    with open(os.path.join(obj, "mobility_v2.json"), "w") as f:
        json.dump(MOBILITY_V2, f)


def run_datagen(tmp: str, render_kw: dict | None = None,
                points_kw: dict | None = None,
                vis_thresh: int = 1000) -> dict:
    """Renders the object (``render_data_item(**render_kw)``), samples its
    point clouds (``process_one_data(**points_kw)``), labels it
    (``label_one_data``) and writes the task files (``save_annotations``)
    under ``tmp``; with no arguments, at the reference's defaults (960 px,
    5 poses x 8 joint values, 32768 points a frame). Returns the task
    files and each stage's seconds."""
    from a3vlm_tpu_torch.datagen.labeler import (
        label_one_data,
        save_annotations,
    )
    from a3vlm_tpu_torch.datagen.point_render import process_one_data
    from a3vlm_tpu_torch.datagen.render_robot import render_data_item

    data_dir = os.path.join(tmp, "dataset")
    out_dir = os.path.join(tmp, "render")
    write_object(data_dir)
    secs = {}
    t0 = time.perf_counter()
    if not render_data_item("101", data_dir, out_dir, **(render_kw or {})):
        raise AssertionError("render_data_item failed")
    secs["render"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if not process_one_data("101", out_dir, **(points_kw or {})):
        raise AssertionError("process_one_data failed")
    secs["points"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tasks = label_one_data("101", None, data_dir, out_dir,
                           vis_thresh=vis_thresh)
    if not isinstance(tasks, dict):
        raise AssertionError(f"label_one_data failed: {tasks}")
    files = save_annotations(tasks, os.path.join(tmp, "vqa"), "Box")
    secs["label"] = time.perf_counter() - t0
    return {"files": files, "seconds": secs, "render_dir": out_dir}


def gate_files(files) -> tuple:
    """The four task files the gate trains on: 2D box, 2D joint, 3D box and
    3D joint."""
    rec = next(f for f in files if "single_link_rec" in f)
    joint = next(
        f for f in files
        if "joint_rec_tasks" in f and "ext" not in f and "sep" not in f
        and "3d" not in f
    )
    rec3d = next(f for f in files if "single_link_3d_rec" in f)
    joint3d = next(f for f in files if "joint_3d_rec_tasks" in f)
    return rec, joint, rec3d, joint3d


def build_tasks(tmp: str) -> tuple:
    """The gate corpus: the object rendered at 192 px, 2 camera poses x 2
    joint values, 4096 points a frame; returns ``gate_files``."""
    # the labeler draws its question templates from the global RNG
    random.seed(0)
    out = run_datagen(tmp, dict(
        num_poses=2, camera_info=CAMERA_INFO, num_joint_value=2,
        cam_radius_min=3.0, cam_radius_max=4.0, seed=0),
        points_kw=dict(sample_size=4096, gaussian_noise=0.0, seed=0),
        vis_thresh=100)
    return gate_files(out["files"])


def write_data_yaml(tmp: str, files) -> str:
    path = os.path.join(tmp, "data.yaml")
    with open(path, "w") as f:
        f.write("META:\n" + "".join(
            f" - path: {p}\n   type: image_text\n" for p in files))
    return path


def card_config(vocab_size: int = 128):
    """``tiny_ens5_config`` at the smallest widths whose every call lands
    in a kernel's domain on the card: the decoder's head dim 64 (the decode
    kernels take 64 or 128) over 2 heads, and its linears' inputs (128,
    and the SwiGLU width 384) multiples of 128, so that the int4 tile and
    K8 (half and group multiples of 64) take them; the ViT towers at head
    dim 32 (two heads of a width of 64). Depth, image sizes, crops and the
    rest as in the tiny config."""
    from a3vlm_tpu_torch.config import tiny_ens5_config

    tiny = tiny_ens5_config(vocab_size)
    vit = dict(width=64, heads=2)
    return dataclasses.replace(
        tiny,
        llama=tiny.llama.replace(dim=128, n_heads=2, n_kv_heads=2,
                                 multiple_of=128),
        clip=dataclasses.replace(tiny.clip, **vit),
        blip2_vision=dataclasses.replace(tiny.blip2_vision, **vit),
        qformer=dataclasses.replace(tiny.qformer, encoder_width=64),
        dinov2=dataclasses.replace(tiny.dinov2, **vit),
    )


def gate_model(tok_dir: str, device: str = "cuda", cfg=None, seed: int = 0):
    """The gate's ``llama_ens5`` with random weights from ``seed``, in
    float32: ``tiny_ens5_config`` on the CPU, ``card_config`` on the
    card."""
    from a3vlm_tpu_torch.config import tiny_ens5_config
    from a3vlm_tpu_torch.meta import MetaModel

    if cfg is None:
        cfg = (tiny_ens5_config() if torch.device(device).type == "cpu"
               else card_config())
    return MetaModel("llama_ens5", tokenizer_path=tok_dir, with_visual=True,
                     max_seq_len=448, model_cfg=cfg, seed=seed,
                     dtype=torch.float32, device=device)


def compute_dtype_for(model) -> torch.dtype:
    """float32 on the CPU (the JAX gate's); bf16 compute on the card, whose
    attention kernels take bf16 alone."""
    return torch.float32 if model.device.type == "cpu" else torch.bfloat16


def gate_lr(cfg) -> float:
    """AdamW's rate for the gate model: 2e-3 at the JAX gate's decoder
    width of 64, scaled by 64 / dim for a wider one (``LR_AT_DIM_64``)."""
    return LR_AT_DIM_64 * 64 / cfg.llama.dim


def make_trainer(model, yaml_cfg: str, compute_dtype: torch.dtype,
                 lr: float | None = None):
    """The JAX gate's training (tests/test_accuracy_gate.py:67-111) in the
    port: the dialog dataset (max_words 448), ``FinetuneDistSampler`` seed
    0 at batch 4, AdamW with clip 8 over the trainable leaves (the towers
    frozen) at ``lr``, by default ``gate_lr`` (2e-3 for the tiny model).
    With a ``compute_dtype`` other than float32 the trainables stay
    float32 masters and the frozen leaves take that dtype. Returns (step,
    state, loader, sampler, to_device)."""
    from a3vlm_tpu_torch.data.dialog import FinetuneDialogDataset
    from a3vlm_tpu_torch.data.loader import DataLoader
    from a3vlm_tpu_torch.data.sampler import FinetuneDistSampler
    from a3vlm_tpu_torch.data.transforms import get_transform
    from a3vlm_tpu_torch.main_finetune import batch_to_device, make_loss_fn
    from a3vlm_tpu_torch.train.step import (
        TrainState,
        make_optimizer,
        make_train_step,
    )
    from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

    cfg = model.cfg
    dataset = FinetuneDialogDataset(
        str(yaml_cfg),
        transform=get_transform("padded_resize", cfg.image_size),
        # 8-corner 3D box answers are ~141 tokens under the tiny BPE:
        # max_words must leave them untruncated after the image words
        max_words=448,
        image_words=model.get_image_words(),
        tokenizer=model.tokenizer,
    )
    bs = 4
    sampler = FinetuneDistSampler(
        dataset, num_replicas=1, rank=0, batch_size=bs, acc_grad=1, seed=0
    )
    loader = DataLoader(dataset, sampler, batch_size=bs, accum_steps=1)
    mask = model.get_trainable_params()
    if compute_dtype != torch.float32:
        model.params = mixed_precision_policy(model.params, mask,
                                              compute_dtype)
    opt = make_optimizer(gate_lr(cfg) if lr is None else lr,
                         max_grad_norm=8.0)
    step = make_train_step(make_loss_fn(model, compute_dtype, remat=False),
                           opt, trainable_mask=mask)
    state = TrainState.create(model.params, opt, mask)
    device = model.device

    def to_device(batch):
        return batch_to_device(batch, device, compute_dtype)

    return step, state, loader, sampler, to_device


def train_to_memorization(model, yaml_cfg: str, max_epochs: int = 400,
                          log=print, compute_dtype=None,
                          lr: float | None = None) -> dict:
    """Trains ``model`` on the task files of ``yaml_cfg`` until the
    largest batch loss of an epoch is below ``STOP_LOSS`` (or
    ``max_epochs``), then leaves the trained weights in ``model.params``.
    The sampler groups batches of one task type, so the stop rule reads
    the epoch's largest batch loss: the long 3D answers memorize later than
    the 2D boxes. ``compute_dtype`` defaults to ``compute_dtype_for``,
    ``lr`` to ``gate_lr``. Returns the epochs, steps, final loss, seconds
    and each epoch's largest batch loss."""
    lr = gate_lr(model.cfg) if lr is None else lr
    step, state, loader, sampler, to_device = make_trainer(
        model, yaml_cfg, compute_dtype or compute_dtype_for(model), lr)
    t0 = time.perf_counter()
    history, steps = [], 0
    for epoch in range(max_epochs):
        sampler.set_epoch(epoch, 0)
        losses = []
        for batch in loader:
            state, m = step(state, to_device(batch))
            losses.append(m["loss"])
            steps += 1
        history.append(max(float(v) for v in losses))
        if epoch % 20 == 0:
            log(f"gate train epoch {epoch} max loss {history[-1]:.4f}")
        if history[-1] < STOP_LOSS:
            break
    secs = time.perf_counter() - t0
    log(f"gate train done: epoch {epoch} max loss {history[-1]:.4f} "
        f"({steps} steps at lr {lr:g}, {secs:.1f} s)")
    model.params = state.params
    return {"epochs": len(history), "steps": steps,
            "final_loss": history[-1], "seconds": secs, "history": history}


def serve_dtype(model, dtype: torch.dtype) -> None:
    """Every floating leaf of ``model.params`` in ``dtype`` (the card
    serves in bf16); packed weights stay as they are."""
    from a3vlm_tpu_torch.quant import QuantizedWeight, tree_map

    def cast(p):
        if isinstance(p, QuantizedWeight) or not p.is_floating_point():
            return p
        return p.to(dtype)

    model.params = tree_map(cast, model.params)
    model._generator = None


def _answers(server, task_file: str, max_gen_len: int):
    """The task file's items through ``VQADataset`` (the eval path's
    prompts and images) and ``server.generate``, greedy, stopped at the
    conversation's ``###``; returns the items and the raw answers."""
    from a3vlm_tpu_torch.data.conversation import conv_templates
    from a3vlm_tpu_torch.eval_affordance import VQADataset

    ds = VQADataset(task_file, input_size=server.model.cfg.image_size)
    items = [ds[i] for i in range(len(ds))]
    conv_sep = conv_templates["v1"]().response_end_signal
    raws = server.generate(
        [it["prompt"] for it in items],
        images=np.stack([it["image"] for it in items]),
        max_gen_len=max_gen_len,
        temperature=0.0,
        additional_stop_symbols=[conv_sep],
    )
    return items, raws


def score_2d(server, task_file: str, with_tag: bool) -> dict:
    """tests/test_accuracy_gate.py's ``_score``: rotated IoU of each parsed
    2D box against the ground truth (0 where either does not parse), and
    with ``with_tag`` whether the joint type matches."""
    from a3vlm_tpu_torch.codecs.triad import (
        parse_rotated_box,
        parse_tagged_answer,
    )
    from a3vlm_tpu_torch.datagen.utils import rotated_box_iou

    items, raws = _answers(server, task_file, MAX_GEN_2D)
    ious, types_ok = [], []
    for it, raw in zip(items, raws):
        ans, gt = raw.split("###")[0], it["annotation"]
        if with_tag:
            _, plabel, ans = parse_tagged_answer(ans)
            _, glabel, gt = parse_tagged_answer(gt)
            types_ok.append(plabel == glabel)
        pb, gb = parse_rotated_box(ans), parse_rotated_box(gt)
        if pb is None or gb is None or len(pb) != len(gb):
            ious.append(0.0)
            continue

        def to_px(b):
            return (
                b[0] * 100, b[1] * 100, b[2] * 100, b[3] * 100,
                math.degrees(b[4]),
            )

        ious.append(rotated_box_iou(to_px(pb), to_px(gb)))
    return {"ious": ious, "types_ok": types_ok, "raws": raws}


def score_3d_box(server, task_file: str) -> dict:
    """The 3D box stream (tests/test_accuracy_gate.py:241-268): the mean
    corner distance of each parsed 8-corner box and its exact OBB IoU (inf
    and 0 where the answer does not parse)."""
    from a3vlm_tpu_torch.codecs.triad import parse_bbox_3d_eight_points
    from a3vlm_tpu_torch.datagen.utils import obb_iou_3d

    items, raws = _answers(server, task_file, MAX_GEN_3D)
    corner_dists, ious3d = [], []
    for it, raw in zip(items, raws):
        pa = parse_bbox_3d_eight_points(raw.split("###")[0])
        ga = parse_bbox_3d_eight_points(it["annotation"])
        if ga is None:
            raise AssertionError(f"ground truth does not parse: "
                                 f"{it['annotation']!r}")
        if pa is None:
            corner_dists.append(np.inf)
            ious3d.append(0.0)
            continue
        corner_dists.append(float(np.linalg.norm(pa - ga, axis=-1).mean()))
        ious3d.append(obb_iou_3d(pa, ga))
    return {"corner_dists": corner_dists, "ious3d": ious3d, "raws": raws}


def score_3d_joint(server, task_file: str) -> dict:
    """The 3D joint stream (tests/test_accuracy_gate.py:276-301): whether
    the tagged joint type matches and the angle between the predicted and
    true axis directions (180 where either does not parse)."""
    from a3vlm_tpu_torch.codecs.triad import (
        parse_axis_3d,
        parse_tagged_answer,
    )

    items, raws = _answers(server, task_file, MAX_GEN_3D)
    types_ok, angles = [], []
    for it, raw in zip(items, raws):
        _, ptype, ans_s = parse_tagged_answer(raw.split("###")[0])
        _, gtype, gt_s = parse_tagged_answer(it["annotation"])
        types_ok.append(ptype == gtype)
        pa, ga = parse_axis_3d(ans_s), parse_axis_3d(gt_s)
        if pa is None or ga is None:
            angles.append(180.0)
            continue
        dp, dg = pa[1] - pa[0], ga[1] - ga[0]
        denom = np.linalg.norm(dp) * np.linalg.norm(dg)
        if denom < 1e-9:
            angles.append(180.0)
            continue
        cos = abs(float(np.dot(dp, dg) / denom))
        angles.append(math.degrees(math.acos(min(cos, 1.0))))
    return {"types_ok": types_ok, "angles": angles, "raws": raws}


def accuracy_gate(server, files) -> tuple[dict, list]:
    """Scores the four streams and holds each metric to the JAX gate's
    threshold. Returns (metrics, the failed checks)."""
    rec, joint, rec3d, joint3d = files
    r2 = score_2d(server, rec, with_tag=False)
    j2 = score_2d(server, joint, with_tag=True)
    b3 = score_3d_box(server, rec3d)
    j3 = score_3d_joint(server, joint3d)
    m = {
        "rec_2d_mean_iou": float(np.mean(r2["ious"])),
        "joint_2d_mean_iou": float(np.mean(j2["ious"])),
        "joint_2d_type_acc": float(np.mean(j2["types_ok"])),
        "box_3d_median_corner_dist": float(np.median(b3["corner_dists"])),
        "box_3d_median_obb_iou": float(np.median(b3["ious3d"])),
        "box_3d_share_corner_dist_le_0.1": float(np.mean(
            [d <= MAX_MEDIAN_CORNER_DIST for d in b3["corner_dists"]])),
        "joint_3d_type_acc": float(np.mean(j3["types_ok"])),
        "joint_3d_median_axis_deg": float(np.median(j3["angles"])),
        "n_items": [len(r2["ious"]), len(j2["ious"]),
                    len(b3["corner_dists"]), len(j3["angles"])],
    }
    checks = [
        (len(r2["ious"]) >= 4, "fewer than 4 2D box items"),
        (len(b3["corner_dists"]) >= 4, "fewer than 4 3D box items"),
        (m["rec_2d_mean_iou"] >= MIN_MEAN_IOU_2D,
         f"2D box IoU {r2['ious']}"),
        (m["joint_2d_mean_iou"] >= MIN_MEAN_IOU_2D,
         f"2D joint IoU {j2['ious']}"),
        (m["joint_2d_type_acc"] == 1.0, "2D joint type mispredicted"),
        (m["box_3d_median_corner_dist"] <= MAX_MEDIAN_CORNER_DIST,
         f"3D corner distances {b3['corner_dists']}"),
        (m["box_3d_median_obb_iou"] >= MIN_MEDIAN_OBB_IOU,
         f"3D box IoU {b3['ious3d']}"),
        (m["box_3d_share_corner_dist_le_0.1"] >= 0.5,
         f"3D corner distances {b3['corner_dists']}"),
        (m["joint_3d_type_acc"] == 1.0, "3D joint type mispredicted"),
        (m["joint_3d_median_axis_deg"] <= MAX_MEDIAN_AXIS_DEG,
         f"3D axis angle errors {j3['angles']}"),
    ]
    return m, [why for ok, why in checks if not ok]


def a8_scores(server, rec_file: str, rec3d_file: str) -> dict:
    """scripts/quant_end_task_gate.py's two metrics: the 2D box mean IoU
    and the 3D mean OBB IoU, rounded to 4 places."""
    return {
        "rec_2d_miou": round(float(np.mean(
            score_2d(server, rec_file, with_tag=False)["ious"])), 4),
        "rec_3d_miou3d": round(float(np.mean(
            score_3d_box(server, rec3d_file)["ious3d"])), 4),
    }


def a8_gate(server, rec_file: str, rec3d_file: str, tol: float = 0.05,
            log=print) -> dict:
    """scripts/quant_end_task_gate.py's ``main`` after training: the model
    scored dense, then after ``quantize(bits=4)`` exact, with
    ``W4A8_DECODE`` and with ``W8A8_PREFILL`` (``W8A8_PREFILL_MIN_M = 64``:
    the gate's prompts are about 220 rows). Each flag is restored after
    its arm. Returns the results, the verdicts (deltas against int4, pass
    when none is below ``-tol``) and each arm's seconds."""
    from a3vlm_tpu_torch.ops import quant_matmul as qm

    model = server.model
    results, secs = {}, {}

    def run(label):
        model._generator = None
        t0 = time.perf_counter()
        results[label] = a8_scores(server, rec_file, rec3d_file)
        secs[label] = time.perf_counter() - t0
        log(f"{label}: {results[label]}")

    run("dense")
    model.quantize(bits=4)
    run("int4")
    flags = (qm.W4A8_DECODE, qm.W8A8_PREFILL, qm.W8A8_PREFILL_MIN_M)
    try:
        qm.W4A8_DECODE = True
        run("int4_w4a8")
        qm.W4A8_DECODE = flags[0]
        qm.W8A8_PREFILL = True
        qm.W8A8_PREFILL_MIN_M = 64
        run("int4_w8a8p")
    finally:
        qm.W4A8_DECODE, qm.W8A8_PREFILL, qm.W8A8_PREFILL_MIN_M = flags
        model._generator = None
    base = results["int4"]
    verdicts = {}
    for mode in ("int4_w4a8", "int4_w8a8p"):
        deltas = {k: round(results[mode][k] - base[k], 4) for k in base}
        verdicts[mode] = {"deltas_vs_int4": deltas,
                          "pass": all(d >= -tol for d in deltas.values())}
    return {"results": results, "verdicts": verdicts, "seconds": secs}


def run_gates(tmp: str, device: str = "cuda", max_epochs: int = 400,
              tol: float = 0.05, log=print, tok_dir: str | None = None
              ) -> dict:
    """The whole loop in ``tmp``: the gate corpus, the model, training to
    memorization, the accuracy gate through ``ModelServer`` and the A8
    gate on the same model. Returns every metric, the failed checks and
    the seconds of each part; raises only where a stage cannot go on."""
    from a3vlm_tpu_torch.serving import ModelServer

    secs = {}
    t0 = time.perf_counter()
    tok_dir = tok_dir or build_tokenizer(tmp)
    files = build_tasks(tmp)
    secs["corpus"] = time.perf_counter() - t0
    model = gate_model(tok_dir, device)
    train = train_to_memorization(
        model, write_data_yaml(tmp, files), max_epochs=max_epochs, log=log)
    if not train["final_loss"] < FINAL_LOSS:
        raise AssertionError(f"the gate model failed to memorize (final "
                             f"loss {train['final_loss']})")
    secs["train"] = train["seconds"]
    serve_dtype(model, compute_dtype_for(model))
    server = ModelServer(meta_model=model, device=device)
    t0 = time.perf_counter()
    metrics, failures = accuracy_gate(server, files)
    secs["accuracy_gate"] = time.perf_counter() - t0
    log(f"accuracy gate: {json.dumps(metrics)}")
    t0 = time.perf_counter()
    a8 = a8_gate(server, files[0], files[2], tol=tol, log=log)
    secs["a8_gate"] = time.perf_counter() - t0
    failures += [f"A8 mode {mode} below int4 by more than {tol}: "
                 f"{v['deltas_vs_int4']}"
                 for mode, v in a8["verdicts"].items() if not v["pass"]]
    return {"config": model.cfg, "train": train, "accuracy": metrics,
            "a8": a8, "failures": failures, "seconds": secs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--max_epochs", type=int, default=400)
    ap.add_argument("--tol", type=float, default=0.05,
                    help="max allowed end-task metric drop of an A8 mode "
                    "vs the int4-exact base")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the card), or cpu for the float32 tiny "
                    "model")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu")
    with tempfile.TemporaryDirectory(prefix="torch_gate_") as tmp:
        out = run_gates(tmp, args.device, args.max_epochs, args.tol)
    print(json.dumps({"train": out["train"], "accuracy": out["accuracy"],
                      "results": out["a8"]["results"],
                      "verdicts": out["a8"]["verdicts"],
                      "failures": out["failures"]}))
    return 1 if out["failures"] else 0


if __name__ == "__main__":
    sys.exit(main())
