"""Both ends of the main path in the port against the JAX package: a tiny
llama_ens5 consolidated checkpoint written here goes through each
package's ``MetaModel.from_pretrained``, then a task JSON through
``VQADataset`` + ``run_eval`` (or the whole ``main``), and the results JSON
comes out. The checkpoint carries the true vocab (the loader pads it), the
decoder's config.json and the tiny tokenizer; both packages build the tiny
towers (their ``Ens5Config`` patched here, as nothing else in them sizes
the towers of a checkpoint).

Tolerances: at temperature 0 in float32 the results JSON is byte-identical
(the slice tests hold the same logits to 1e-4 and the same greedy ids);
``compute_logits`` / ``evaluate_examples`` and the LoRA-served logits to
1e-4 (float32 on both sides, summation order differs); the bf16 CLI runs
are compared on what does not depend on the generated text (record count,
order, question, image, annotation, schema), as bf16 rounds at other
places in the two frameworks."""

import dataclasses
import json
import re
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu import main_finetune as jfinetune
from a3vlm_tpu.checkpoint.export import ens5_params_to_consolidated
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.tools import score_results as jscore
from a3vlm_tpu.train import lora as jlora
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch import main_finetune as tfinetune
from a3vlm_tpu_torch import meta as tmeta
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.ops import quant_matmul as qmm
from a3vlm_tpu_torch.tools import score_results as tscore

torch.set_num_threads(1)
ATOL = 1e-4
MAX_SEQ = 512
SIZE = 56  # the tiny towers' image size
QUESTIONS = (
    "Please provide the joint's type and its 2D rotated bounding box "
    "linked to the object part door",
    "<image>\nDetect all manipulable object parts and provide their "
    "rotated bounding boxes.",
)
JOINT_RE = re.compile(r"<rb>(revolute|prismatic|fixed|continuous)</rb>"
                      r"\[[0-9,\-]+\]")


_real_init = jens5.init_ens5_params


@pytest.fixture(scope="module")
def tiny_towers():
    """Both packages size a checkpoint's towers with the tiny config: a
    config made from the decoder's alone gets the tiny towers."""
    mp = pytest.MonkeyPatch()
    for module, tiny in ((jens5, jens5.tiny_ens5_config()),
                         (tmeta, tiny_ens5_config())):
        def make(llama, _real=module.Ens5Config, _tiny=tiny, **kw):
            if kw:
                return _real(llama=llama, **kw)
            return dataclasses.replace(_tiny, llama=llama)

        mp.setattr(module, "Ens5Config", make)
    # the JAX constructor's random weights, which the checkpoint replaces,
    # as zeros: its eager init takes ~30 s on the CPU
    mp.setattr(jens5, "init_ens5_params", lambda key, cfg, dtype=jnp.float32:
               jax.tree_util.tree_map(
                   lambda x: jnp.zeros(x.shape, dtype),
                   jax.eval_shape(lambda k: _real_init(k, cfg), key)))
    yield
    mp.undo()


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, tiny_tokenizer_dir, tiny_tokenizer):
    n = tiny_tokenizer.n_words
    cfg = jens5.tiny_ens5_config(vocab_size=-(-n // 128) * 128)
    # the JAX init's tree, filled from numpy (its eager init is slow here)
    rng = np.random.default_rng(11)
    shapes = jax.eval_shape(lambda k: _real_init(k, cfg),
                            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(
        lambda x: (1.0 + 0.1 * rng.standard_normal(x.shape)
                   if len(x.shape) == 1 else
                   0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes)
    sd = ens5_params_to_consolidated(params, cfg)
    for k in ("llma.tok_embeddings.weight", "llma.output.weight"):
        sd[k] = sd[k][:n]  # a released checkpoint holds the true vocab
    d = tmp_path_factory.mktemp("ckpt")
    torch.save({"model": {k: torch.from_numpy(np.array(v))
                          for k, v in sd.items()}},
               d / "consolidated.00-of-01.model.pth")
    (d / "meta.json").write_text(json.dumps({"llama_type": "llama_ens5"}))
    (d / "config.json").write_text(json.dumps(
        {"dim": 64, "n_layers": 2, "n_heads": 4, "n_kv_heads": 4,
         "multiple_of": 16}))
    for f in Path(tiny_tokenizer_dir).iterdir():
        shutil.copy(f, d / f.name)
    return d


def _write_tasks(d: Path, name: str) -> str:
    """Two PNG images and one point cloud, two questions each; the file
    name routes ``fsm_for_task`` to the joint grammar."""
    rng = np.random.default_rng(0)
    paths = []
    for i, (h, w) in enumerate(((48, 64), (60, 40))):
        p = d / f"img{i}.png"
        Image.fromarray(rng.integers(0, 255, (h, w, 3)).astype(np.uint8)
                        ).save(p)
        paths.append(str(p))
    pc = rng.uniform(-1, 1, (300, 6)).astype(np.float32)
    pc[:, 3:] = rng.uniform(0, 1, (300, 3))
    np.save(d / "cloud.npy", pc)
    paths.append(str(d / "cloud.npy"))
    records = [{"image": p, "conversations": [
        {"from": "human", "value": q},
        {"from": "gpt", "value": f"<rb>revolute</rb>[{i}.00,1.00]"}]}
        for i, (p, q) in enumerate((p, q) for p in paths for q in QUESTIONS)]
    task = d / name
    task.write_text(json.dumps(records))
    return str(task)


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    return _write_tasks(tmp_path_factory.mktemp("tasks"),
                        "joint_rec_tasks.json")


@pytest.fixture(scope="module")
def models(tiny_towers, ckpt):
    """The checkpoint loaded by each package in float32."""
    jm = JMetaModel.from_pretrained(str(ckpt), with_visual=True,
                                    max_seq_len=MAX_SEQ, dtype=jnp.float32)
    tm = MetaModel.from_pretrained(str(ckpt), with_visual=True,
                                   max_seq_len=MAX_SEQ, dtype=torch.float32,
                                   device="cpu")
    return jm, tm


def test_from_pretrained_loads_the_same_weights(models):
    """Every leaf of the port's loaded tree equals the JAX package's
    (vocab rows and columns zero-padded past the true vocab)."""
    jm, tm = models
    want = jax.tree_util.tree_flatten_with_path(
        jax.tree_util.tree_map(np.asarray, jm.params))[0]
    got = dict(jax.tree_util.tree_flatten_with_path(
        params_to_numpy(tm.params))[0])
    assert len(got) == len(want)
    for path, w in want:
        np.testing.assert_array_equal(got[path], w, err_msg=str(path))
    V = tm.args.vocab_size
    assert tm.params["llama"]["output"]["weight"].shape == (64, V)
    assert not tm.params["llama"]["output"]["weight"][
        :, tm.true_vocab:].any()
    assert tm.get_quant_blocklist() == jm.get_quant_blocklist()


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["free", "grammar"])
def test_run_eval_matches_jax_byte_for_byte(models, tasks, constrained):
    jm, tm = models
    fsm_j = fsm_t = None
    if constrained:
        fsm_j = jconstrained.fsm_for_task("joint_rec", jm.tokenizer)
        fsm_t = tconstrained.fsm_for_task("joint_rec", tm.tokenizer)
    kw = dict(batch_size=2, max_gen_len=64 if constrained else 16,
              temperature=0.0)
    want = jeval.run_eval(jm, jeval.VQADataset(tasks, input_size=SIZE),
                          fsm=fsm_j, **kw)
    got = teval.run_eval(tm, teval.VQADataset(tasks, input_size=SIZE),
                         fsm=fsm_t, **kw)
    assert json.dumps(got) == json.dumps(want)
    assert len(got) == 6
    if constrained:  # every answer a complete joint triad
        for r in got:
            assert JOINT_RE.fullmatch(r["answer"].strip()), r
            assert len(r["format_answer"]) == 5, r


def test_vqa_dataset_items_equal_jax(tmp_path):
    tasks = _write_tasks(tmp_path, "items.json")
    for kw in ({}, {"max_samples": 4, "seed": 3},
               {"existing_results": [{"image": str(tmp_path / "img0.png"),
                                      "question": QUESTIONS[0]}]}):
        want = jeval.VQADataset(tasks, input_size=SIZE, **kw)
        got = teval.VQADataset(tasks, input_size=SIZE, **kw)
        assert len(got) == len(want)
        for i in range(len(want)):
            a, b = got[i], want[i]
            assert a.keys() == b.keys()
            for k in a:
                if k == "image":
                    assert a[k].dtype == b[k].dtype == np.float32
                    np.testing.assert_array_equal(a[k], b[k])
                else:
                    assert a[k] == b[k], k
    assert got.data[-1]["image"].endswith(".npy")
    assert teval._question_of(want.data[1]) == jeval._question_of(
        want.data[1])


def test_main_matches_jax_main_bf16(tiny_towers, ckpt, tasks, tmp_path):
    """Both CLIs on the same checkpoint at their default bf16."""
    argv = ["--pretrained_path", str(ckpt), "--dataset", tasks,
            "--batch_size", "2", "--max_gen_len", "4", "--max_seq_len",
            str(MAX_SEQ), "--temperature", "0", "--input_size", str(SIZE),
            "--max_samples", "2"]
    with open(jeval.main(argv + ["--output_dir", str(tmp_path / "j")])) as f:
        want = json.load(f)
    tfile = teval.main(argv + ["--output_dir", str(tmp_path / "t"),
                               "--device", "cpu"])
    assert Path(tfile).name == "results_joint_rec_tasks.json"
    with open(tfile) as f:
        got = json.load(f)
    assert len(got) == len(want) == 2
    keys = ("question", "image", "annotation")
    assert [[r[k] for k in keys] for r in got] == [
        [r[k] for k in keys] for r in want]
    for r in got:
        assert r.keys() == want[0].keys()
        assert isinstance(r["answer"], str) and isinstance(r["fail"], bool)
        assert all(isinstance(x, float) for x in r["format_answer"])


@pytest.mark.parametrize("extra", [
    ["--quant"], ["--quant", "--quant_bits", "8"],
    ["--quant", "--w4a8"], ["--quant", "--w8a8_prefill"],
    ["--tower_bits", "8"], ["--kv_cache_bits", "8"],
    ["--draft_k", "4", "--batch_size", "1"], ["--constrained"],
    ["--score"], ["--dataset_registry"],
], ids=lambda e: "_".join(a.strip("-") for a in e))
def test_main_modes_on_the_cpu(tiny_towers, ckpt, tasks, tmp_path, extra,
                               monkeypatch, capsys):
    """The port's CLI in each mode its flags set, on the CPU."""
    monkeypatch.setattr(qmm, "W4A8_DECODE", False)
    monkeypatch.setattr(qmm, "W8A8_PREFILL", False)
    dataset = tasks
    if extra == ["--dataset_registry"]:
        reg = tmp_path / "registry.json"
        reg.write_text(json.dumps({"joint_rec": tasks}))
        extra, dataset = ["--dataset_registry", str(reg)], "joint_rec"
    argv = ["--pretrained_path", str(ckpt), "--dataset", dataset,
            "--batch_size", "2", "--max_gen_len", "4", "--max_seq_len",
            str(MAX_SEQ), "--temperature", "0", "--input_size", str(SIZE),
            "--output_dir", str(tmp_path), "--device", "cpu", "--max_samples",
            "2"]
    with open(teval.main(argv + extra)) as f:
        records = json.load(f)
    assert len(records) == 2
    out = capsys.readouterr().out
    assert qmm.W4A8_DECODE == ("--w4a8" in extra)
    assert qmm.W8A8_PREFILL == ("--w8a8_prefill" in extra)
    if "--constrained" in extra:
        assert "grammar FSM with" in out
    if "--score" in extra:  # the summary of the two records, printed
        summary = json.loads(out[out.index("{"):])
        assert sum(row["n"] for row in summary.values()) == 2


@pytest.mark.parametrize("extra,item", [
    (["--model_parallel_size", "2"], "item 17"),
    (["--llama_type", "falcon"], "item 15"),
])
def test_unported_flags_name_their_item(tmp_path, extra, item):
    argv = ["--dataset", str(tmp_path / "t.json"), "--tiny_random_model",
            "--device", "cpu"] + extra
    with pytest.raises(NotImplementedError, match=f"ROADMAP Queue 1 {item}"):
        teval.main(argv)


def test_scoring_apis_match_jax(models):
    jm, tm = models
    texts = ["hello door", "the answer is <rb>revolute</rb>"]
    images = np.random.default_rng(1).normal(
        size=(2, SIZE, SIZE, 3)).astype(np.float32)
    for kw in ({}, {"images": images}):
        for a, b in zip(tm.compute_logits(texts, **kw),
                        jm.compute_logits(texts, **kw)):
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    contexts = ["hello", "the answer is"]
    got = tm.evaluate_examples(texts, contexts)
    want = jm.evaluate_examples(texts, contexts)
    for k in ("log_likelihood", "ppl"):
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, rtol=0)
    assert got["max_equal"] == want["max_equal"]
    for a, b in zip(got["non_context_logits"], want["non_context_logits"]):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_stream_generate_ends_as_generate(models):
    _, tm = models
    image = np.random.default_rng(2).normal(
        size=(SIZE, SIZE, 3)).astype(np.float32)
    for stops in ((), ("\n###",)):
        chunks = list(tm.stream_generate("hello door", image=image,
                                         max_gen_len=12,
                                         additional_stop_symbols=stops))
        assert chunks[-1]["end_of_content"]
        assert all(not c["end_of_content"] for c in chunks[:-1])
        want = tm.generate(["hello door"], images=image[None],
                           max_gen_len=12, temperature=0.0,
                           additional_stop_symbols=stops)[0]
        assert chunks[-1]["text"] == want


def test_load_lora_matches_jax(tiny_towers, ckpt, tmp_path):
    """Unmerged adapters on the loaded decoder, dense and int4."""
    for bits in (None, 4):
        jm = JMetaModel.from_pretrained(str(ckpt), max_seq_len=MAX_SEQ,
                                        dtype=jnp.float32)
        tm = MetaModel.from_pretrained(str(ckpt), max_seq_len=MAX_SEQ,
                                       dtype=torch.float32, device="cpu")
        if bits:
            jm.quantize(bits=bits)
            tm.quantize(bits=bits)
        lora = jlora.init_lora_params(jax.random.PRNGKey(5),
                                      jm.params["llama"], rank=4)
        rng = np.random.default_rng(bits or 0)
        lora = jax.tree_util.tree_map(
            lambda x: np.asarray(x) + rng.normal(
                scale=0.05, size=x.shape).astype(np.float32), lora)
        jm.load_lora(lora)
        tm.load_lora(params_from_numpy({"lora": lora}, device="cpu")["lora"])
        texts = ["hello door", "open the drawer please"]
        got = tm.compute_logits(texts)
        for a, b in zip(got, jm.compute_logits(texts)):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        # the decode loop serves the same adapters: its first greedy id is
        # the argmax of the last prompt position (the JAX Generator cannot
        # serve them: attach_lora meets its per-layer decode layout)
        prompt = tm.tokenizer.encode(texts[1], bos=True, eos=False)
        first = tm.generate_tokens([prompt], max_gen_len=1,
                                   stop_tokens=())[0][0]
        assert first == int(got[1][-1].argmax())
    # the same adapters from a trainable-only checkpoint of the port give
    # the same logits
    mgr = CheckpointManager(str(tmp_path))
    path = mgr.save(0, params=params_from_numpy({"lora": lora},
                                                device="cpu"))
    fresh = MetaModel.from_pretrained(str(ckpt), max_seq_len=MAX_SEQ,
                                      dtype=torch.float32, device="cpu")
    fresh.quantize(bits=4)
    fresh.load_adapter_checkpoint(path)
    for a, b in zip(fresh.compute_logits(texts), got):
        np.testing.assert_array_equal(a, b)


def test_score_results_prints_as_the_original(models, tasks, tmp_path,
                                              capsys):
    """On records with a string ``format_answer`` the copy prints what the
    original prints. On the eval CLI's own records (``format_answer`` the
    repaired list) the original raises and the copy scores the answers:
    what the original prints for the same records with ``format_answer``
    taken out."""
    box = "[0.50,0.50,0.30,0.20,0.00]"
    records = [
        {"answer": f"<rb>revolute</rb>{box}",
         "format_answer": "<rb>revolute</rb>[0.52,0.49,0.30,0.20,1.00]",
         "annotation": f"<rb>revolute</rb>{box}", "question": QUESTIONS[0],
         "image": "x.png", "fail": False},
        {"answer": "Opened", "format_answer": "Opened",
         "annotation": "Closed", "image": "y.png", "fail": True,
         "question": "What is the articulation status? Opened or Closed"},
        {"answer": "garbage", "format_answer": "garbage", "fail": True,
         "annotation": box, "image": "z.png",
         "question": "2D rotated bounding box"},
    ]
    path = tmp_path / "results.json"
    path.write_text(json.dumps(records))
    capsys.readouterr()
    want = jscore.main([str(path)])
    printed = capsys.readouterr().out
    assert tscore.main([str(path)]) == want
    assert capsys.readouterr().out == printed

    jm, _ = models
    records = jeval.run_eval(
        jm, jeval.VQADataset(tasks, input_size=SIZE), batch_size=2,
        max_gen_len=8, temperature=0.0)
    path.write_text(json.dumps(records))
    with pytest.raises((TypeError, AttributeError)):
        jscore.main([str(path)])
    stripped = tmp_path / "stripped.json"
    stripped.write_text(json.dumps(
        [{k: v for k, v in r.items() if k != "format_answer"}
         for r in records]))
    capsys.readouterr()
    want = jscore.main([str(stripped)])
    printed = capsys.readouterr().out
    summary = tscore.main([str(path)])
    assert sum(row["n"] for row in summary.values()) == 6
    assert json.dumps(summary, sort_keys=True) == json.dumps(
        want, sort_keys=True)
    assert capsys.readouterr().out == printed


def test_finetune_from_pretrained_matches_jax(tiny_towers, ckpt,
                                              tiny_tokenizer_dir, tmp_path):
    """``main_finetune --pretrained_path``: two steps on the same
    checkpoint and data in both packages, float32, the same mean loss."""
    img = tmp_path / "img.png"
    Image.new("RGB", (64, 48), (10, 200, 30)).save(img)
    records = [{"image": str(img), "conversations": [
        {"from": "human", "value": f"Where is door {i}?"},
        {"from": "gpt", "value": f"door {i} here"}]} for i in range(4)]
    (tmp_path / "tasks.json").write_text(json.dumps(records))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n - path: {tmp_path / 'tasks.json'}\n"
                   "   type: image_text\n")
    argv = ["--tokenizer_path", tiny_tokenizer_dir, "--data_config",
            str(cfg), "--dialog", "--pretrained_path", str(ckpt),
            "--batch_size", "2", "--epochs", "1", "--warmup_epochs", "0",
            "--lr", "1e-3", "--max_words", "128", "--precision", "fp32",
            "--print_freq", "1"]
    jfinetune.main(argv + ["--output_dir", str(tmp_path / "j"),
                           "--num_devices", "1"])
    state = tfinetune.main(argv + ["--output_dir", str(tmp_path / "t"),
                                   "--device", "cpu"])
    assert state.step == 2
    want, got = (json.loads((tmp_path / d / "log.txt").read_text()
                            .splitlines()[0]) for d in ("j", "t"))
    assert abs(got["closs"] - want["closs"]) < ATOL, (got, want)
