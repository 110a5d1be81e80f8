"""Both ends of the path for the families beside ``llama_ens5``: a tiny
consolidated checkpoint of each (``internlm_ems5_light``: the decoder, the
projector and the image tags; ``llama_ens5_2images``: everything, the
towers and the depth tags included; ``llama``: the decoder) goes through
each package's ``MetaModel.from_pretrained``, ``run_eval`` and ``main``.

Both packages build the tiny configs (their ``InternlmEns5Config`` and
``Ens5Config`` patched here: nothing else sizes the towers of a
checkpoint). ``internlm_ems5_light``'s checkpoint holds no towers, so each
package keeps its own random DINOv2 and ConvNeXt (``meta.py:244-274``):
the results are compared after the same tower weights are put into both.

Tolerances: ``from_pretrained`` leaf for leaf exact on every leaf it
imports; at temperature 0 in float32 the results JSON byte-identical; the
CLIs at their default bf16 compared on what does not depend on the
generated text. Where the JAX CLI fails (``llama`` and the 2-image model
through ``run_eval``, which passes no depth images; ``llama`` and
``internlm_ems5_light`` through the slot pool), the port fails too,
before writing records."""

import dataclasses
import json
import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_eval import MAX_SEQ, _write_tasks, tiny_towers  # noqa: F401
from test_torch_families import LLAMA_TINY, numpy_tree

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu import eval_affordance as jeval
from a3vlm_tpu.checkpoint.export import (
    decoder_params_to_consolidated,
    ens5_params_to_consolidated,
)
from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import ens5_2images as je2
from a3vlm_tpu.models import internlm_ems5_light as jil
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch import eval_affordance as teval
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import falcon as tfalcon
from a3vlm_tpu_torch.models import internlm_ems5_light as til

torch.set_num_threads(1)
FAMILIES = ("internlm_ems5_light", "llama_ens5_2images", "llama")
SIZES = {"internlm_ems5_light": 128, "llama_ens5_2images": 56, "llama": 56}
TOWERS = ("convnext", "dinov2")
TINY_DECODER = {"internlm_ems5_light": dict(dim=64, n_layers=2, n_heads=4,
                                            n_kv_heads=2, multiple_of=16),
                "llama_ens5_2images": dict(dim=64, n_layers=2, n_heads=4,
                                           n_kv_heads=4, multiple_of=16),
                "llama": LLAMA_TINY}


@pytest.fixture(scope="module")
def tiny_configs(tiny_towers):
    """Both packages' ``InternlmEns5Config()`` is the tiny one; the JAX
    random init, which the checkpoint and the shared towers replace, is
    zeros (its eager init takes ~20 s here)."""
    mp = pytest.MonkeyPatch()
    for module in (jil, til):
        def make(_real=module.InternlmEns5Config, _t=module.tiny_config(),
                 **kw):
            return _real(**kw) if kw else _t

        mp.setattr(module, "InternlmEns5Config", make)
    real = jil.init_params
    mp.setattr(jil, "init_params", lambda key, cfg, dtype=jnp.float32:
               jax.tree_util.tree_map(
                   lambda x: jnp.zeros(x.shape, dtype),
                   jax.eval_shape(lambda k: real(k, cfg), key)))
    yield
    mp.undo()


def _state_dict(family: str, vocab: int):
    """(consolidated state dict, the numpy tree it was made from)."""
    if family == "internlm_ems5_light":
        tree = numpy_tree(jil.init_params, jil.tiny_config(vocab), 31)
        sd = decoder_params_to_consolidated(tree["llama"])
        p = tree["visual_proj"]
        sd.update({"llma.visual_proj.0.weight": p["linear"]["weight"].T,
                   "llma.visual_proj.0.bias": p["linear"]["bias"],
                   "llma.visual_proj.1.weight": p["ln"]["weight"],
                   "llma.visual_proj.1.bias": p["ln"]["bias"],
                   "llma.start_img": tree["start_img"],
                   "llma.end_img": tree["end_img"]})
    elif family == "llama_ens5_2images":
        cfg = jens5.tiny_ens5_config(vocab)
        tree = numpy_tree(je2.init_params, cfg, 32)
        sd = ens5_params_to_consolidated(tree, cfg)
    else:
        args = JModelArgs(vocab_size=vocab, max_seq_len=MAX_SEQ,
                          **LLAMA_TINY)
        tree = numpy_tree(jllama.init_llama_params, args, 33)
        sd = decoder_params_to_consolidated(tree)
    return sd, tree


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory, tiny_tokenizer_dir, tiny_tokenizer):
    """One tiny consolidated checkpoint a family, holding the true vocab,
    its ``meta.json``, the decoder's ``config.json`` and the tokenizer."""
    n = tiny_tokenizer.n_words
    out = {}
    for family in FAMILIES:
        sd, tree = _state_dict(family, -(-n // 128) * 128)
        for k in ("llma.tok_embeddings.weight", "llma.output.weight"):
            sd[k] = sd[k][:n]
        d = tmp_path_factory.mktemp(family)
        torch.save({"model": {k: torch.from_numpy(np.array(v))
                              for k, v in sd.items()}},
                   d / "consolidated.00-of-01.model.pth")
        (d / "meta.json").write_text(json.dumps({"llama_type": family}))
        (d / "config.json").write_text(json.dumps(TINY_DECODER[family]))
        for f in Path(tiny_tokenizer_dir).iterdir():
            shutil.copy(f, d / f.name)
        out[family] = (d, tree)
    return out


@pytest.fixture(scope="module")
def loaded(tiny_configs, ckpts):
    """Each checkpoint loaded by each package in float32; the internlm
    models then carry the same tower weights."""
    out = {}
    for family, (d, tree) in ckpts.items():
        jm = JMetaModel.from_pretrained(str(d), with_visual=True,
                                        max_seq_len=MAX_SEQ,
                                        dtype=jnp.float32)
        tm = MetaModel.from_pretrained(str(d), with_visual=True,
                                       max_seq_len=MAX_SEQ,
                                       dtype=torch.float32, device="cpu")
        assert tm.llama_type == jm.llama_type == family
        out[family] = (jm, tm)
    return out


@pytest.fixture(scope="module")
def tasks(tmp_path_factory):
    return _write_tasks(tmp_path_factory.mktemp("tasks"),
                        "joint_rec_tasks.json")


def _leaves(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


@pytest.mark.parametrize("family", FAMILIES)
def test_from_pretrained_loads_the_same_weights(loaded, family):
    """Every leaf the JAX method imports equals the port's (vocab rows and
    columns zero-padded past the true vocab); ``internlm_ems5_light``'s
    towers are each package's own initialization, as the JAX method leaves
    them."""
    jm, tm = loaded[family]
    want = _leaves(jax.tree_util.tree_map(np.asarray, jm.params))
    got = _leaves(params_to_numpy(tm.params))
    assert got.keys() == want.keys()
    imported = [p for p in want
                if not (family == "internlm_ems5_light"
                        and p[0].key in TOWERS)]
    assert len(imported) < len(want) or family != "internlm_ems5_light"
    for path in imported:
        np.testing.assert_array_equal(got[path], want[path],
                                      err_msg=str(path))
    assert tm.args == dataclasses.replace(tm.args, **{
        f: getattr(jm.args, f) for f in tm.args.__dataclass_fields__})
    assert tm.image_words == jm.image_words
    assert tm.get_quant_blocklist() == jm.get_quant_blocklist()
    assert not tm.decoder["output"]["weight"][:, tm.true_vocab:].any()


def _shared_towers(jm, tm):
    """The JAX model's towers, bridged into the port's model."""
    for k in TOWERS:
        tm.params[k] = params_from_numpy(
            jax.tree_util.tree_map(np.asarray, jm.params[k]), device="cpu")


def _fill_towers(jm, seed: int):
    tree = numpy_tree(jil.init_params, jil.tiny_config(jm.args.vocab_size),
                      seed)
    jm.params = dict(jm.params)
    for k in TOWERS:
        jm.params[k] = jax.tree_util.tree_map(jnp.asarray, tree[k])
    jm._encode_image_jit = None


@pytest.mark.parametrize("constrained", [False, True],
                         ids=["free", "grammar"])
def test_internlm_run_eval_matches_jax_byte_for_byte(loaded, tasks,
                                                     constrained):
    jm, tm = loaded["internlm_ems5_light"]
    _fill_towers(jm, 34)
    _shared_towers(jm, tm)
    fsm_j = fsm_t = None
    if constrained:
        fsm_j = jconstrained.fsm_for_task("joint_rec", jm.tokenizer)
        fsm_t = tconstrained.fsm_for_task("joint_rec", tm.tokenizer)
    kw = dict(batch_size=2, max_gen_len=48 if constrained else 12,
              temperature=0.0)
    size = SIZES["internlm_ems5_light"]
    want = jeval.run_eval(jm, jeval.VQADataset(tasks, input_size=size),
                          fsm=fsm_j, **kw)
    got = teval.run_eval(tm, teval.VQADataset(tasks, input_size=size),
                         fsm=fsm_t, **kw)
    assert json.dumps(got) == json.dumps(want)
    assert len(got) == 6


@pytest.mark.parametrize("family", ["llama_ens5_2images", "llama"])
def test_run_eval_fails_as_jax_does(loaded, tasks, family):
    """``run_eval`` passes images and no depth images: the JAX 2-image
    model asserts on the missing depth stream and the JAX ``llama`` model
    has no tower module; the port refuses both at ``encode_images``."""
    jm, tm = loaded[family]
    ds = SIZES[family]
    with pytest.raises(AssertionError if family != "llama"
                       else AttributeError):
        jeval.run_eval(jm, jeval.VQADataset(tasks, input_size=ds),
                       batch_size=2, max_gen_len=4, temperature=0.0)
    with pytest.raises(ValueError, match="depth|no images"):
        teval.run_eval(tm, teval.VQADataset(tasks, input_size=ds),
                       batch_size=2, max_gen_len=4, temperature=0.0)


def test_2images_slot_pool_matches_jax_byte_for_byte(loaded, tasks):
    """The JAX slot pool serves the 2-image model on the RGB stream alone
    (ens5's towers and tags, 1455 words a prefix, no depth): so does the
    port's, record for record."""
    jm, tm = loaded["llama_ens5_2images"]
    kw = dict(batch_size=2, max_gen_len=12, temperature=0.0)
    size = SIZES["llama_ens5_2images"]
    want = jeval.run_eval_continuous(
        jm, jeval.VQADataset(tasks, input_size=size), **kw)
    got = teval.run_eval_continuous(
        tm, teval.VQADataset(tasks, input_size=size), **kw)
    assert json.dumps(got) == json.dumps(want)
    assert len(got) == 6


def _argv(d, tasks, family, out, *extra):
    return ["--pretrained_path", str(d), "--dataset", tasks, "--llama_type",
            family, "--batch_size", "2", "--max_gen_len", "4",
            "--max_seq_len", str(MAX_SEQ), "--temperature", "0",
            "--input_size", str(SIZES[family]), "--max_samples", "2",
            "--output_dir", str(out), *extra]


@pytest.mark.parametrize("family", FAMILIES)
def test_main_per_family_as_the_jax_cli(tiny_configs, ckpts, tasks,
                                        tmp_path, family):
    """The CLIs at their default bf16 with ``--llama_type``,
    ``--input_size`` and the checkpoint's ``config.json``: the 2-image and
    text-only families fail at ``encode_images`` in both, no results file
    written; the 7B family writes its records in order and in the schema
    (the JAX CLI cannot run it here: XLA on the CPU has no bf16 x bf16 ->
    f32 dot for its grouped-query attention, so its records are held
    against the JAX ``VQADataset``'s items)."""
    d = ckpts[family][0]
    targv = _argv(d, tasks, family, tmp_path / "t", "--device", "cpu")
    if family != "internlm_ems5_light":
        with pytest.raises(AssertionError if family != "llama"
                           else AttributeError):
            jeval.main(_argv(d, tasks, family, tmp_path / "j"))
        with pytest.raises(ValueError, match="depth|no images"):
            teval.main(targv)
        assert not list((tmp_path / "t").glob("results_*"))
        return
    with open(teval.main(targv)) as f:
        got = json.load(f)
    ds = jeval.VQADataset(tasks, input_size=SIZES[family], max_samples=2)
    want = [ds[i] for i in range(len(ds))]
    assert len(got) == len(want) == 2
    assert [[r["question"], r["image"], r["annotation"]] for r in got] == [
        [w["question"], w["image_path"], w["annotation"]] for w in want]
    for r in got:
        assert list(r) == ["answer", "format_answer", "annotation",
                           "question", "image", "fail"]
        assert isinstance(r["answer"], str) and isinstance(r["fail"], bool)


@pytest.mark.parametrize("family", ["internlm_ems5_light", "llama"])
def test_continuous_batching_refused_where_jax_fails(loaded, tasks,
                                                     tmp_path, family):
    """The JAX slot pool fails on these after loading (``llama``: no
    ``params["llama"]``; ``internlm_ems5_light``: ens5's five-crop encode
    on another config, at the first prefix); the port's CLI refuses before
    reading a checkpoint."""
    jm = loaded[family][0]
    with pytest.raises(KeyError if family == "llama" else AttributeError):
        jeval.run_eval_continuous(
            jm, jeval.VQADataset(tasks, input_size=SIZES[family]),
            batch_size=2, max_gen_len=4, temperature=0.0)
    with pytest.raises(ValueError, match="continuous_batching"):
        teval.main(_argv(tmp_path / "no_such_checkpoint", tasks, family,
                         tmp_path / "t", "--continuous_batching",
                         "--device", "cpu"))


def test_falcon_still_refused():
    """``falcon`` is ported (``tests/test_torch_falcon.py``), but its
    checkpoints are still refused: the JAX ``from_pretrained`` fails on
    them (it imports them with LLaMA's importer), so the port's raises
    ``ValueError`` before it reads anything."""
    model = MetaModel("falcon", vocab_size=128, device="cpu",
                      model_cfg=tfalcon.FalconArgs(
                          num_layers=1, hidden_size=32,
                          num_attention_heads=4, num_kv_heads=2))
    assert model.args.vocab_size == 128 and model.image_words == 0
    with pytest.raises(ValueError, match="falcon"):
        MetaModel.from_pretrained("no_such_dir", llama_type="falcon",
                                  device="cpu")
    with pytest.raises(KeyError, match="unknown llama_type"):
        MetaModel("gpt", vocab_size=128, device="cpu")
