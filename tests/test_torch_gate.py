"""The pieces of the port's closed-loop gates (scripts/torch_end_task_gate.py)
against the JAX package's (tests/test_accuracy_gate.py and
scripts/quant_end_task_gate.py), on the CPU. The loop itself (training to
memorization) is not run here: the JAX gate's file alone takes minutes.

- the gate corpus: the port's datagen against the JAX fixture's steps
  (``task_files``), the four task files equal;
- training: the first 3 steps of the gate's recipe (AdamW 2e-3, clip 8,
  batch 4, the sampler's seed 0) on the same tiny ``llama_ens5`` weights
  (bridged), the losses to 1e-4 (float32 on both sides, summation order
  differs);
- scoring: ``score_2d``, ``score_3d_box`` and ``score_3d_joint`` through
  the port's ``ModelServer`` against the JAX gate's ``_score`` and its 3D
  scoring on the same untrained weights (the same raw strings, IoUs,
  corner distances and angles), and on the same answers (a stub server
  that returns perturbed ground truths), where the metrics are not zero;
- the A8 gate's arms, flags and verdicts."""

import json
import math
import random
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu_torch.checkpoint.bridge import params_to_numpy
from a3vlm_tpu_torch.serving import ModelServer
from scripts import torch_end_task_gate as gate
from tests.test_accuracy_gate import _score as jax_score

torch.set_num_threads(1)
ATOL = 1e-4


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The gate corpus from each package: the port's ``build_tasks``, and
    the JAX ``task_files`` fixture's steps with the global RNG (which the
    labeler draws question templates from) seeded alike."""
    from a3vlm_tpu.datagen.labeler import label_one_data, save_annotations
    from a3vlm_tpu.datagen.point_render import process_one_data
    from a3vlm_tpu.datagen.render_robot import render_data_item

    from tests.test_datagen_pipeline import CAMERA_INFO

    port_tmp = tmp_path_factory.mktemp("port_gate")
    port = gate.build_tasks(str(port_tmp))
    tmp = tmp_path_factory.mktemp("jax_gate")
    data_dir, out_dir = tmp / "dataset", tmp / "render"
    gate.write_object(str(data_dir))
    assert render_data_item(
        "101", str(data_dir), str(out_dir), num_poses=2,
        camera_info=CAMERA_INFO, num_joint_value=2,
        cam_radius_min=3.0, cam_radius_max=4.0, seed=0,
    )
    assert process_one_data(
        "101", str(out_dir), sample_size=4096, gaussian_noise=0.0, seed=0
    )
    random.seed(0)
    tasks = label_one_data(
        "101", None, str(data_dir), str(out_dir), vis_thresh=100
    )
    files = save_annotations(tasks, str(tmp / "vqa"), "Box")
    return (port_tmp, port), (tmp, gate.gate_files(files))


def test_gate_corpus_equals_jax(corpora):
    (pt, port), (jt, jax_files) = corpora
    assert [f.rsplit("/", 1)[1] for f in port] == [
        f.rsplit("/", 1)[1] for f in jax_files]
    for p, j in zip(port, jax_files):
        got = json.loads(open(p).read().replace(str(pt), "<root>"))
        want = json.loads(open(j).read().replace(str(jt), "<root>"))
        assert got == want and len(got) == 4


def test_the_object_is_the_jax_tests_object():
    from tests import test_datagen_pipeline as t

    assert (gate.URDF_XML, gate.MOBILITY_V2, gate.SEMANTICS,
            gate.CAMERA_INFO) == (t.URDF_XML, t.MOBILITY_V2, t.SEMANTICS,
                                  t.CAMERA_INFO)


@pytest.fixture(scope="module")
def models(corpora, tiny_tokenizer_dir):
    """The gate model of each package on the same weights: the port's
    random tiny ``llama_ens5`` (``gate_model`` on the CPU) and the JAX
    ``MetaModel`` over the same tree (bridged)."""
    from a3vlm_tpu.meta import MetaModel as JMetaModel
    from a3vlm_tpu.models import ens5 as jens5

    tm = gate.gate_model(tiny_tokenizer_dir, "cpu")
    tree = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(tm.params))
    jm = JMetaModel("llama_ens5", tokenizer_path=tiny_tokenizer_dir,
                    with_visual=True, max_seq_len=448,
                    model_cfg=jens5.tiny_ens5_config(), params=tree,
                    dtype=jnp.float32)
    assert tm.cfg.llama.vocab_size == jm.cfg.llama.vocab_size
    return jm, tm


def _jax_losses(jm, yaml_cfg: str, n: int) -> list:
    """tests/test_accuracy_gate.py's ``_train_to_memorization``, its first
    ``n`` steps."""
    from a3vlm_tpu.data.dialog import FinetuneDialogDataset
    from a3vlm_tpu.data.loader import DataLoader
    from a3vlm_tpu.data.sampler import FinetuneDistSampler
    from a3vlm_tpu.data.transforms import get_transform
    from a3vlm_tpu.models import ens5 as ens5_mod
    from a3vlm_tpu.train import (
        TrainState,
        make_optimizer,
        make_train_step,
        next_token_loss,
    )

    cfg = jm.cfg
    dataset = FinetuneDialogDataset(
        yaml_cfg, transform=get_transform("padded_resize", cfg.image_size),
        max_words=448, image_words=jm.get_image_words(),
        tokenizer=jm.tokenizer)
    sampler = FinetuneDistSampler(dataset, num_replicas=1, rank=0,
                                  batch_size=4, acc_grad=1, seed=0)
    loader = DataLoader(dataset, sampler, batch_size=4, accum_steps=1)
    opt = make_optimizer(2e-3, max_grad_norm=8.0,
                         trainable_mask=jm.get_trainable_params())

    def loss_fn(params, batch):
        logits = ens5_mod.forward(params, cfg, batch["examples"],
                                  image=batch.get("image"))
        return next_token_loss(logits, batch["labels"],
                               vocab_size=jm.true_vocab)

    step = jax.jit(make_train_step(loss_fn, opt))
    state = TrainState.create(jm.params, opt)
    sampler.set_epoch(0, 0)
    losses = []
    for batch in loader:
        state, m = step(state, {k: jnp.asarray(v) for k, v in batch.items()})
        losses.append(float(m["loss"]))
        if len(losses) == n:
            return losses


def test_first_training_steps_match_jax(corpora, models, tmp_path):
    (_, files), _ = corpora
    jm, tm = models
    yaml_cfg = gate.write_data_yaml(str(tmp_path), files)
    want = _jax_losses(jm, yaml_cfg, 3)
    # a model of its own: the steps update its leaves in place
    from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
    from a3vlm_tpu_torch.meta import MetaModel

    tm2 = MetaModel("llama_ens5", with_visual=True, max_seq_len=448,
                    model_cfg=tm.cfg, tokenizer=tm.tokenizer,
                    params=params_from_numpy(params_to_numpy(tm.params),
                                             device="cpu"), device="cpu")
    step, state, loader, sampler, to_device = gate.make_trainer(
        tm2, yaml_cfg, gate.compute_dtype_for(tm2))
    sampler.set_epoch(0, 0)
    got = []
    for batch in loader:
        state, m = step(state, to_device(batch))
        got.append(float(m["loss"]))
        if len(got) == 3:
            break
    np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)
    assert got[2] < got[0]


class _Capture:
    """A model whose ``generate`` keeps the raw answers it returns."""

    def __init__(self, model):
        self.model, self.raws = model, []

    def generate(self, *args, **kw):
        out = self.model.generate(*args, **kw)
        self.raws += out
        return out


def _jax_3d(model, rec3d_file: str, joint3d_file: str, input_size: int):
    """tests/test_accuracy_gate.py's 3D scoring
    (``test_closed_loop_3d_triad_accuracy``), its metrics returned."""
    from a3vlm_tpu.codecs.triad import (
        parse_axis_3d,
        parse_bbox_3d_eight_points,
        parse_tagged_answer,
    )
    from a3vlm_tpu.data.conversation import conv_templates
    from a3vlm_tpu.datagen.utils import obb_iou_3d
    from a3vlm_tpu.eval_affordance import VQADataset

    conv_sep = conv_templates["v1"]().response_end_signal

    def raws_for(task_file):
        ds = VQADataset(task_file, input_size=input_size)
        items = [ds[i] for i in range(len(ds))]
        raws = model.generate(
            [it["prompt"] for it in items],
            images=np.stack([it["image"] for it in items]),
            max_gen_len=170, temperature=0.0,
            additional_stop_symbols=[conv_sep])
        return items, [r.split("###")[0] for r in raws]

    items, answers = raws_for(rec3d_file)
    corner_dists, ious3d = [], []
    for it, ans in zip(items, answers):
        pa = parse_bbox_3d_eight_points(ans)
        ga = parse_bbox_3d_eight_points(it["annotation"])
        if pa is None:
            corner_dists.append(np.inf)
            ious3d.append(0.0)
            continue
        corner_dists.append(float(np.linalg.norm(pa - ga, axis=-1).mean()))
        ious3d.append(obb_iou_3d(pa, ga))
    items_j, answers_j = raws_for(joint3d_file)
    types_ok, angles = [], []
    for it, ans in zip(items_j, answers_j):
        _, ptype, ans_s = parse_tagged_answer(ans)
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
    return corner_dists, ious3d, types_ok, angles


def _port_scores(server, files):
    rec, joint, rec3d, joint3d = files
    r2 = gate.score_2d(server, rec, with_tag=False)
    j2 = gate.score_2d(server, joint, with_tag=True)
    b3 = gate.score_3d_box(server, rec3d)
    j3 = gate.score_3d_joint(server, joint3d)
    return (r2, j2, b3, j3), (r2["raws"] + j2["raws"] + b3["raws"]
                              + j3["raws"])


def _jax_scores(model, files, input_size):
    rec, joint, rec3d, joint3d = files
    ious, _ = jax_score(model, rec, input_size, with_tag=False)
    ious_j, types_j = jax_score(model, joint, input_size, with_tag=True)
    return (ious, ious_j, types_j,
            *_jax_3d(model, rec3d, joint3d, input_size))


def _assert_same_scores(port, jax_):
    r2, j2, b3, j3 = port
    ious, ious_j, types_j, dists, ious3d, types3d, angles = jax_
    np.testing.assert_allclose(r2["ious"], ious, atol=1e-12, rtol=0)
    np.testing.assert_allclose(j2["ious"], ious_j, atol=1e-12, rtol=0)
    assert j2["types_ok"] == types_j
    np.testing.assert_allclose(b3["corner_dists"], dists, atol=1e-12, rtol=0)
    np.testing.assert_allclose(b3["ious3d"], ious3d, atol=1e-12, rtol=0)
    assert j3["types_ok"] == types3d
    np.testing.assert_allclose(j3["angles"], angles, atol=1e-9, rtol=0)


def test_scores_on_the_same_weights_match_jax(corpora, models):
    """Untrained weights: the same raw answers and the same metrics."""
    (_, files), _ = corpora
    jm, tm = models
    cap = _Capture(jm)
    want = _jax_scores(cap, files, jm.cfg.image_size)
    got, raws = _port_scores(ModelServer(meta_model=tm, device="cpu"), files)
    assert raws == cap.raws and len(raws) == 16
    _assert_same_scores(got, want)


class _Answers:
    """A stub server: ``generate`` answers each prompt with its item's
    ground truth, every number scaled by a seeded factor within ``1 +-
    scale``, and leaves one item's answer unparseable."""

    def __init__(self, task_files, input_size: int, scale: float):
        from a3vlm_tpu_torch.eval_affordance import VQADataset

        self.model = type("M", (), {"cfg": type(
            "C", (), {"image_size": input_size})()})()
        self.by_prompt = {}
        rng = np.random.default_rng(7)
        for f in task_files:
            ds = VQADataset(f, input_size=input_size)
            for i in range(len(ds)):
                it = ds[i]
                gt = it["annotation"]
                out = "".join(
                    f"{float(t) * (1 + rng.uniform(-scale, scale)):.2f}"
                    if _is_number(t) else t for t in _split_numbers(gt))
                self.by_prompt.setdefault(it["prompt"], []).append(out)
        first = next(iter(self.by_prompt))
        self.by_prompt[first][0] = "no answer"

    def generate(self, prompts, **kw):
        return [self.by_prompt[p].pop(0) + "###" for p in prompts]


def _split_numbers(s: str) -> list:
    return re.split(r"(-?\d+\.\d+)", s)


def _is_number(t: str) -> bool:
    return re.fullmatch(r"-?\d+\.\d+", t) is not None


def test_scores_of_the_same_answers_match_jax(corpora):
    """Perturbed ground truths (one answer unparseable) through the
    port's scoring and the JAX gate's: the same metrics, not all zero; the
    accuracy gate's checks pass on the exact answers and fail on these."""
    (_, files), _ = corpora
    size = 56
    got, _ = _port_scores(_Answers(files, size, 0.2), files)
    want = _jax_scores(_Answers(files, size, 0.2), files, size)
    _assert_same_scores(got, want)
    assert 0 < np.mean(got[0]["ious"]) < 1
    assert 0 < np.median(got[2]["ious3d"]) < 1
    metrics, failures = gate.accuracy_gate(_Answers(files, size, 0.0), files)
    assert metrics["box_3d_median_obb_iou"] == 1.0
    assert failures == []
    _, failures = gate.accuracy_gate(_Answers(files, size, 3.0), files)
    assert failures


def test_a8_gate_arms_and_verdicts(monkeypatch):
    """Each arm runs with its flag set (W8A8 prefill at M >= 64) on the
    int4 model, the flags come back after, and a delta below ``-tol``
    fails its mode."""
    from a3vlm_tpu_torch.ops import quant_matmul as qm

    calls = []
    scores = iter([0.9, 0.8, 0.79, 0.7])  # dense, int4, w4a8, w8a8p

    class Model:
        _generator = None

        def quantize(self, bits):
            calls.append(("quantize", bits))

    def fake_scores(server, rec, rec3d):
        calls.append((qm.W4A8_DECODE, qm.W8A8_PREFILL,
                      qm.W8A8_PREFILL_MIN_M))
        v = next(scores)
        return {"rec_2d_miou": v, "rec_3d_miou3d": v}

    monkeypatch.setattr(gate, "a8_scores", fake_scores)
    flags = (qm.W4A8_DECODE, qm.W8A8_PREFILL, qm.W8A8_PREFILL_MIN_M)
    server = type("S", (), {"model": Model()})()
    out = gate.a8_gate(server, "rec", "rec3d", tol=0.05, log=lambda s: None)
    assert (qm.W4A8_DECODE, qm.W8A8_PREFILL, qm.W8A8_PREFILL_MIN_M) == flags
    assert calls == [flags, ("quantize", 4), flags,
                     (True, flags[1], flags[2]), (flags[0], True, 64)]
    assert list(out["results"]) == ["dense", "int4", "int4_w4a8",
                                    "int4_w8a8p"]
    assert out["verdicts"]["int4_w4a8"]["pass"]
    assert not out["verdicts"]["int4_w8a8p"]["pass"]
    assert out["verdicts"]["int4_w8a8p"]["deltas_vs_int4"] == {
        "rec_2d_miou": -0.1, "rec_3d_miou3d": -0.1}
