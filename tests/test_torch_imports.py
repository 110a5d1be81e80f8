"""The PyTorch port stands alone: no file of ``a3vlm_tpu_torch`` nor
``chip_smoke.py`` imports ``jax`` or the JAX package ``a3vlm_tpu``, and each
module the port keeps its own copy of behaves as the original does on the
same seeded input."""

import ast
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

ROOT = Path(__file__).resolve().parent.parent
PORT_FILES = sorted((ROOT / "a3vlm_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "a3vlm_tpu")


def _imported_roots(path: Path) -> set[str]:
    """Top-level package names of every import statement in a file, also
    those inside functions."""
    roots = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add((node.module or "").split(".")[0])
    return roots


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_file_imports_no_jax_package(path):
    assert not _imported_roots(path) & set(FORBIDDEN), path


def test_port_entry_points_load_neither_package():
    code = ("import sys, a3vlm_tpu_torch.meta, a3vlm_tpu_torch.main_finetune, "
            "a3vlm_tpu_torch.eval_affordance, "
            "a3vlm_tpu_torch.tools.score_results, "
            "a3vlm_tpu_torch.checkpoint.ens5_import, "
            "a3vlm_tpu_torch.lookup_decode, a3vlm_tpu_torch.constrained, "
            "a3vlm_tpu_torch.serving_batch, "
            "a3vlm_tpu_torch.tokenizer, a3vlm_tpu_torch.data.dialog, "
            "a3vlm_tpu_torch.data.alpaca, a3vlm_tpu_torch.data.loader, "
            "a3vlm_tpu_torch.checkpoint.manager, "
            "a3vlm_tpu_torch.checkpoint.export, "
            "a3vlm_tpu_torch.train.feature_cache, "
            "a3vlm_tpu_torch.train.param_groups, "
            "a3vlm_tpu_torch.tools.merge_lora, "
            "a3vlm_tpu_torch.tools.convert_weights_to_hf, "
            "a3vlm_tpu_torch.tools.weight_operate; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'a3vlm_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, cwd=ROOT).stdout.strip()
    assert out == "[]"


def test_entry_points_default_to_the_card():
    """The entry points run on the card unless the caller names another
    device, and the inner helpers take theirs as a required argument, so no
    default can put a model on the CPU without a word."""
    import inspect

    from a3vlm_tpu_torch.checkpoint import bridge
    from a3vlm_tpu_torch.meta import MetaModel
    from a3vlm_tpu_torch.models.llama import KVCache
    from a3vlm_tpu_torch.ops import attention, decode_attention, resize, rope

    def default(fn):
        return inspect.signature(fn).parameters["device"].default

    for fn in (MetaModel.__init__, MetaModel.from_pretrained,
               bridge.params_from_numpy, bridge.kv_cache_from_numpy):
        assert default(fn) == "cuda", fn
    from a3vlm_tpu_torch import eval_affordance, main_finetune

    for cli in (eval_affordance.get_args_parser(),
                main_finetune.get_args_parser()):
        assert cli.get_default("device") == "cuda"
    for fn in (KVCache.create, attention.right_aligned_causal_mask,
               rope.precompute_freqs_cis, resize.weight_matrix,
               decode_attention.make_quantized_kv):
        assert default(fn) is inspect.Parameter.empty, fn


def test_no_port_function_defaults_its_device_to_the_cpu():
    found = []
    for path in PORT_FILES:
        for node in ast.walk(ast.parse(path.read_text())):
            if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            a = node.args
            positional = a.posonlyargs + a.args
            pairs = list(zip(positional[len(positional) - len(a.defaults):],
                             a.defaults))
            pairs += [(arg, d) for arg, d in zip(a.kwonlyargs, a.kw_defaults)
                      if d is not None]
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {node.name}"
                      for arg, d in pairs
                      if arg.arg == "device" and isinstance(d, ast.Constant)
                      and d.value == "cpu"]
    assert not found, found


def _write_dialog_data(tmp_path, n=6, dialog=True):
    img = tmp_path / "img.png"
    pixels = np.random.default_rng(0).integers(0, 255, size=(48, 64, 3))
    Image.fromarray(pixels.astype(np.uint8)).save(img)
    if dialog:
        records = [{"image": str(img), "conversations": [
            {"from": "human", "value": f"Where is door {i}?"},
            {"from": "gpt", "value": f"door {i} here"}]} for i in range(n)]
    else:
        records = [{"image": str(img), "instruction": f"Where is door {i}?",
                    "input": "", "output": f"door {i} here"}
                   for i in range(n)]
    (tmp_path / "tasks.json").write_text(json.dumps(records))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n - path: {tmp_path / 'tasks.json'}\n"
                   "   type: image_text\n")
    return cfg, img


def _assert_same(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        np.testing.assert_array_equal(a, b)
    else:
        assert a == b


def _case_config(tmp_path, tok_dir):
    import a3vlm_tpu.config as orig
    import a3vlm_tpu_torch.config as port

    (tmp_path / "a.json").write_text(json.dumps(
        {"dim": 64, "n_layers": 2, "n_heads": 4, "unknown_key": 1}))
    (tmp_path / "b.json").write_text(json.dumps({"n_layers": 3,
                                                 "norm_eps": 1e-6}))
    paths = [tmp_path / "a.json", tmp_path / "b.json"]
    got = port.model_args_from_json(paths, max_seq_len=96)
    want = orig.model_args_from_json(paths, max_seq_len=96)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert dataclasses.asdict(port.ModelArgs()) == dataclasses.asdict(
        orig.ModelArgs())
    assert (got.head_dim, got.kv_heads, got.ffn_hidden_dim) == (
        want.head_dim, want.kv_heads, want.ffn_hidden_dim)


def _case_tokenizer(tmp_path, tok_dir):
    from a3vlm_tpu.tokenizer import Tokenizer as Orig
    from a3vlm_tpu_torch.tokenizer import Tokenizer as Port

    orig, port = Orig(tok_dir), Port(tok_dir)
    assert (port.n_words, port.bos_id, port.eos_id) == (
        orig.n_words, orig.bos_id, orig.eos_id)
    for text in ("### Human: provide the joint's type [0.12,0.34]",
                 "<rb>revolute</rb>[0.12,0.34,0.56,0.78,0.90]"):
        ids = port.encode(text, bos=True, eos=True)
        assert ids == orig.encode(text, bos=True, eos=True)
        assert port.decode(ids) == orig.decode(ids)
        assert port.encode_segment(text) == orig.encode_segment(text)
        assert (port.encode_wo_prefix_space(text)
                == orig.encode_wo_prefix_space(text))
    assert [port.id_to_piece(t) for t in range(40)] == [
        orig.id_to_piece(t) for t in range(40)]


def _case_constrained(tmp_path, tok_dir):
    import a3vlm_tpu.constrained as orig
    import a3vlm_tpu_torch.constrained as port
    from a3vlm_tpu.tokenizer import Tokenizer

    tok = Tokenizer(tok_dir)
    for name in ("joint_rec_grammar", "rotated_box_grammar", "det_all_grammar",
                 "axis_3d_grammar"):
        got = port.compile_grammar(getattr(port, name)(), tok)
        want = orig.compile_grammar(getattr(orig, name)(), tok)
        np.testing.assert_array_equal(got.next_state, want.next_state)
        assert (got.eos_id, got.n_states) == (want.eos_id, want.n_states)
    assert (port.fsm_for_task("eval_joint_rec.json", tok).n_states
            == orig.fsm_for_task("eval_joint_rec.json", tok).n_states)
    assert port.fsm_for_task("free_text.json", tok) is None


def _case_codecs_vocab(tmp_path, tok_dir):
    import a3vlm_tpu.codecs.vocab as orig
    import a3vlm_tpu_torch.codecs.vocab as port

    names = [n for n in dir(orig) if n.isupper()]
    assert names and names == [n for n in dir(port) if n.isupper()]
    for n in names:
        assert getattr(port, n) == getattr(orig, n), n


def _case_spm_convert(tmp_path, tok_dir):
    import a3vlm_tpu.tools.spm_convert as orig
    import a3vlm_tpu_torch.tools.spm_convert as port

    # a hand-made ModelProto: two pieces (field 1: piece, score, type)
    def piece(text, score, kind):
        import struct

        body = (b"\x0a" + bytes([len(text)]) + text.encode()
                + b"\x15" + struct.pack("<f", score) + b"\x18" + bytes([kind]))
        return b"\x0a" + bytes([len(body)]) + body

    blob = piece("<unk>", 0.0, 2) + piece("ab", -1.5, 1)
    assert port.parse_model_proto(blob) == orig.parse_model_proto(blob)
    assert port._read_varint(b"\xac\x02", 0) == orig._read_varint(
        b"\xac\x02", 0) == (300, 2)


def _datasets(tmp_path, tok_dir, module, cls):
    import importlib

    cfg, _ = _write_dialog_data(tmp_path, dialog=module == "dialog")
    out = []
    for pkg in ("a3vlm_tpu", "a3vlm_tpu_torch"):
        data = importlib.import_module(f"{pkg}.data.{module}")
        transforms = importlib.import_module(f"{pkg}.data.transforms")
        tok = importlib.import_module(f"{pkg}.tokenizer").Tokenizer(tok_dir)
        out.append(getattr(data, cls)(
            str(cfg), transform=transforms.get_transform("padded_resize", 56),
            max_words=96, image_words=30, tokenizer=tok))
    return out


def _case_data_dialog(tmp_path, tok_dir):
    """Covers dialog, annotations, conversation and data_reader, which the
    dialog dataset reaches."""
    orig, port = _datasets(tmp_path, tok_dir, "dialog",
                           "FinetuneDialogDataset")
    assert len(port) == len(orig) == 6
    for i in (0, 5):
        _assert_same(port[i], orig[i])


def _case_data_alpaca(tmp_path, tok_dir):
    """Covers alpaca and system_prompt."""
    orig, port = _datasets(tmp_path, tok_dir, "alpaca", "FinetuneDataset")
    assert len(port) == len(orig)
    _assert_same(port[1], orig[1])
    import a3vlm_tpu.data.system_prompt as osp
    import a3vlm_tpu_torch.data.system_prompt as psp

    for d in ({"instruction": "open the door"},
              {"instruction": "open", "input": "the door"}):
        assert psp.format_prompt(d) == osp.format_prompt(d)


def _case_data_sampler_loader(tmp_path, tok_dir):
    import a3vlm_tpu.data.loader as ol
    import a3vlm_tpu.data.sampler as osamp
    import a3vlm_tpu_torch.data.loader as pl
    import a3vlm_tpu_torch.data.sampler as psamp

    orig, port = _datasets(tmp_path, tok_dir, "dialog",
                           "FinetuneDialogDataset")
    batches = []
    for ds, samp, load in ((orig, osamp, ol), (port, psamp, pl)):
        sampler = samp.FinetuneDistSampler(ds, num_replicas=1, rank=0,
                                           batch_size=2, acc_grad=1, seed=3)
        loader = load.DataLoader(ds, sampler, batch_size=2, accum_steps=1,
                                 workers=0)
        batches.append((list(sampler), list(loader)))
    assert batches[0][0] == batches[1][0]
    _assert_same(batches[1][1], batches[0][1])


def _case_data_transforms(tmp_path, tok_dir):
    import a3vlm_tpu.data.transforms as orig
    import a3vlm_tpu_torch.data.transforms as port

    _, img_path = _write_dialog_data(tmp_path)
    img = Image.open(img_path).convert("RGB")
    for kind in ("padded_resize", "resized_center_crop"):
        np.testing.assert_array_equal(port.get_transform(kind, 56)(img),
                                      orig.get_transform(kind, 56)(img))
    pc = np.random.default_rng(1).normal(size=(64, 6)).astype(np.float32)
    np.testing.assert_array_equal(port.pc_norm(pc.copy()),
                                  orig.pc_norm(pc.copy()))


def _defs(path: Path) -> dict:
    """Top-level functions, classes and assignments of a file by name, as
    their AST dumps (imports and the module docstring left out)."""
    out = {}
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.dump(node)
        elif isinstance(node, ast.Assign):
            out[ast.dump(node.targets[0])] = ast.dump(node)
    return out


def _same_defs(rel: str, differ: tuple = ()) -> None:
    """The port's copy of ``rel`` defines what the original defines, each
    definition the same to the AST but those in ``differ``."""
    orig = _defs(ROOT / "a3vlm_tpu" / rel)
    port = _defs(ROOT / "a3vlm_tpu_torch" / rel)
    assert orig.keys() == port.keys()
    for name in orig:
        assert (orig[name] == port[name]) != (name in differ), name


def _both(rel: str):
    import importlib

    mod = rel.removesuffix(".py").replace("/", ".")
    return (importlib.import_module(f"a3vlm_tpu.{mod}"),
            importlib.import_module(f"a3vlm_tpu_torch.{mod}"))


def _case_codecs_geometry(tmp_path, tok_dir):
    _same_defs("codecs/geometry.py")
    orig, port = _both("codecs/geometry.py")
    rng = np.random.default_rng(2)
    pts = rng.normal(size=(40, 3))
    boxes = []
    for mod in (orig, port):
        box = mod.BBox3D()
        box.create_minimum_projected_bbox(pts)
        boxes.append((box.center, box.extent, box.R,
                      mod.matrix_to_rotvec(mod.rotvec_to_matrix(pts[0])),
                      mod.normalize_and_round_angle(187.4)))
    _assert_same(boxes[1], boxes[0])


def _case_codecs_triad(tmp_path, tok_dir):
    _same_defs("codecs/triad.py")
    orig, port = _both("codecs/triad.py")
    box = [412.3, 377.9, 120.5, 64.2, 0.7]
    for mod in (orig, port):
        s = mod.format_joint_answer("revolute",
                                    mod.format_rotated_box(box, 960, 720))
        assert s == orig.format_joint_answer(
            "revolute", orig.format_rotated_box(box, 960, 720))
        assert mod.parse_tagged_answer(s) == orig.parse_tagged_answer(s)
        assert mod.parse_rotated_box(s) == orig.parse_rotated_box(s)


def _case_codecs_bbox_util(tmp_path, tok_dir):
    _same_defs("codecs/bbox_util.py")
    orig, port = _both("codecs/bbox_util.py")
    assert port.denorm_bboxes(640, 480, [0.1, 0.2, 0.5, 0.9]) == \
        orig.denorm_bboxes(640, 480, [0.1, 0.2, 0.5, 0.9])
    assert port.expand2square_offsets(640, 480) == \
        orig.expand2square_offsets(640, 480)


def _case_codecs_repair(tmp_path, tok_dir):
    _same_defs("codecs/repair.py")
    orig, port = _both("codecs/repair.py")
    for raw in ("<rb>revolute</rb>[12.34,56.78,90.12,34.56]###junk",
                "the answer is 0.25,0.5, 1234 ,75", "garbage"):
        a = port.extract_answer(raw)
        assert a == orig.extract_answer(raw)
        box = port.format_bounding_box(a)
        assert box == orig.format_bounding_box(a)
        assert port.check_box_failed(box) == orig.check_box_failed(box)


def _case_codecs_vqa_tasks(tmp_path, tok_dir):
    import random

    _same_defs("codecs/vqa_tasks.py")
    orig, port = _both("codecs/vqa_tasks.py")
    got = []
    for mod in (orig, port):
        random.seed(4)
        got.append(mod.create_single_link_rec_rotated_task(
            "door", [300.0, 200.0, 80.0, 40.0, 0.3], "a.png"))
    assert got[1] == got[0]


def _case_checkpoint_torch_import(tmp_path, tok_dir):
    """Every definition but ``_stack`` is the original's; ``_stack``
    walks the tree itself and stacks as the original (a JAX tree map)
    does, on a nested tree with lists and a None leaf."""
    _same_defs("checkpoint/torch_import.py", differ=("_stack",))
    orig, port = _both("checkpoint/torch_import.py")
    rng = np.random.default_rng(5)
    trees = [{"a": {"w": rng.normal(size=(3, 2)), "b": None},
              "l": [rng.normal(size=4), {"x": rng.normal(size=(2,))}]}
             for _ in range(3)]
    _assert_same(port._stack(trees), orig._stack(trees))
    sd = {"llma.tok_embeddings.weight": rng.normal(size=(8, 4)),
          "llma.norm.weight": rng.normal(size=4),
          "llma.output.weight": rng.normal(size=(8, 4))}
    for group, names in (("attention", ("wq", "wk", "wv", "wo")),
                         ("feed_forward", ("w1", "w2", "w3"))):
        for w in names:
            for i in range(2):
                sd[f"llma.layers.{i}.{group}.{w}.weight"] = rng.normal(
                    size=(4, 4))
    for i in range(2):
        for n in ("attention_norm", "ffn_norm"):
            sd[f"llma.layers.{i}.{n}.weight"] = rng.normal(size=4)
    _assert_same(port.import_llama_consolidated(sd, n_layers=2),
                 orig.import_llama_consolidated(sd, n_layers=2))


def _case_checkpoint_ens5_import(tmp_path, tok_dir):
    _same_defs("checkpoint/ens5_import.py")
    orig, port = _both("checkpoint/ens5_import.py")
    for keys in (["llma.clip.visual.x"], ["llma.layers.0.x"]):
        sd = dict.fromkeys(keys)
        assert port.has_ens5_towers(sd) == orig.has_ens5_towers(sd)


def _case_datagen_utils(tmp_path, tok_dir):
    _same_defs("datagen/utils.py")
    orig, port = _both("datagen/utils.py")
    rng = np.random.default_rng(6)
    corners = [rng.normal(size=(8, 3)) for _ in range(2)]
    assert port.obb_iou_3d(*corners) == orig.obb_iou_3d(*corners)
    boxes = ([50.0, 40.0, 30.0, 20.0, 15.0], [55.0, 42.0, 30.0, 25.0, 40.0])
    assert port.rotated_box_iou(*boxes) == orig.rotated_box_iou(*boxes)


def _case_tools_score_results(tmp_path, tok_dir):
    """The scorer differs only where the original fails: a record whose
    ``format_answer`` is not a string (tests/test_torch_eval.py)."""
    _same_defs("tools/score_results.py", differ=("score_records",))
    orig, port = _both("tools/score_results.py")
    box = "[0.50,0.50,0.30,0.20,0.00]"
    records = [{"question": q, "answer": a, "format_answer": a,
                "annotation": box, "image": "a", "fail": False}
               for q, a in (("2D rotated bounding box of the door", box),
                            ("Detect all manipulable object parts", box),
                            ("provide the 3D axis", "garbage"))]
    assert port.score_records(records) == orig.score_records(records)
    for q in ("provide the 3D bounding box", "What is the status?"):
        assert port.classify(q) == orig.classify(q)


def _case_config_probe(tmp_path, tok_dir):
    import a3vlm_tpu.config as orig
    import a3vlm_tpu_torch.config as port

    assert port.probe_pretrained_dir(tmp_path) == \
        orig.probe_pretrained_dir(tmp_path) == {}
    (tmp_path / "meta.json").write_text(json.dumps(
        {"llama_type": "llama_ens5"}))
    (tmp_path / "config.json").write_text(json.dumps({"dim": 64}))
    assert port.probe_pretrained_dir(tmp_path) == \
        orig.probe_pretrained_dir(tmp_path)


def _case_checkpoint_export(tmp_path, tok_dir):
    _same_defs("checkpoint/export.py")
    orig, port = _both("checkpoint/export.py")
    rng = np.random.default_rng(7)
    L, D, F_ = 2, 8, 12
    layers = {"attention": {w: {"weight": rng.normal(size=(L, D, D))}
                            for w in ("wq", "wk", "wv", "wo")},
              "feed_forward": {
                  "w1": {"weight": rng.normal(size=(L, D, F_))},
                  "w2": {"weight": rng.normal(size=(L, F_, D))},
                  "w3": {"weight": rng.normal(size=(L, D, F_))}},
              "attention_norm": {"weight": rng.normal(size=(L, D))},
              "ffn_norm": {"weight": rng.normal(size=(L, D))}}
    params = {"tok_embeddings": {"weight": rng.normal(size=(16, D))},
              "norm": {"weight": rng.normal(size=D)},
              "output": {"weight": rng.normal(size=(D, 16))},
              "layers": layers}
    _assert_same(port.decoder_params_to_consolidated(params),
                 orig.decoder_params_to_consolidated(params))
    _assert_same(port.export_hf_llama(params, n_heads=2),
                 orig.export_hf_llama(params, n_heads=2))
    a, b = {"x": rng.normal(size=3), "y": np.ones(2)}, {"x": np.ones(3)}
    _assert_same(port.extract_diff(a, b), orig.extract_diff(a, b))


def _case_tools_convert_weights_to_hf(tmp_path, tok_dir):
    """``convert`` differs in its imports alone; the files it writes are
    held against the original's in tests/test_torch_checkpoint.py."""
    _same_defs("tools/convert_weights_to_hf.py", differ=("convert",))


def _case_tools_weight_operate(tmp_path, tok_dir):
    """``operate`` differs in its imports alone; both write the same
    extract and apply files (tests/test_torch_checkpoint.py)."""
    _same_defs("tools/weight_operate.py", differ=("operate",))


def _case_utils_tensorboard_logger(tmp_path, tok_dir):
    """The port's logging module copies the classes its loop uses; the
    TensorBoard facade is the original's, and logs scalars."""
    orig = _defs(ROOT / "a3vlm_tpu" / "utils" / "logging.py")
    port = _defs(ROOT / "a3vlm_tpu_torch" / "utils" / "logging.py")
    assert port["TensorBoardLogger"] == orig["TensorBoardLogger"]
    from a3vlm_tpu_torch.utils.logging import TensorBoardLogger

    tb = TensorBoardLogger(str(tmp_path / "tb"))
    tb.add_scalar("c_train_loss", 1.5, 0)
    tb.flush()
    assert any((tmp_path / "tb").iterdir())


_CASES = {
    "config": _case_config,
    "config.probe_pretrained_dir": _case_config_probe,
    "codecs.geometry": _case_codecs_geometry,
    "codecs.triad": _case_codecs_triad,
    "codecs.bbox_util": _case_codecs_bbox_util,
    "codecs.repair": _case_codecs_repair,
    "codecs.vqa_tasks": _case_codecs_vqa_tasks,
    "checkpoint.torch_import": _case_checkpoint_torch_import,
    "checkpoint.ens5_import": _case_checkpoint_ens5_import,
    "datagen.utils": _case_datagen_utils,
    "tools.score_results": _case_tools_score_results,
    "tokenizer": _case_tokenizer,
    "constrained": _case_constrained,
    "codecs.vocab": _case_codecs_vocab,
    "tools.spm_convert": _case_spm_convert,
    "data.dialog": _case_data_dialog,
    "data.alpaca": _case_data_alpaca,
    "data.sampler+loader": _case_data_sampler_loader,
    "data.transforms": _case_data_transforms,
    "checkpoint.export": _case_checkpoint_export,
    "tools.convert_weights_to_hf": _case_tools_convert_weights_to_hf,
    "tools.weight_operate": _case_tools_weight_operate,
    "utils.logging.TensorBoardLogger": _case_utils_tensorboard_logger,
}


@pytest.mark.parametrize("module", list(_CASES))
def test_copied_module_behaves_as_the_original(module, tmp_path,
                                               tiny_tokenizer_dir):
    _CASES[module](tmp_path, tiny_tokenizer_dir)
