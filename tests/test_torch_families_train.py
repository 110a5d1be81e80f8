"""``main_finetune --llama_type`` for each family in the port against the
JAX CLI, on the tiny consolidated checkpoints of
``test_torch_families_eval.py`` (imported fixtures; both packages'
``Ens5Config`` and ``InternlmEns5Config`` patched to the tiny ones), and
the depth stream of the tower-feature cache.

What the JAX CLI does per type, and what is held here:

- ``llama`` trains (a bare decoder; the loss reads the ids alone, images
  in the data are loaded and ignored): the port's epoch loss equals its;
- ``llama_ens5_2images`` trains on text-only data; on data with images it
  fails at the first step (its datasets load no depth stream, which the
  2-image forward needs): the port fails there too, with ``ValueError``;
- ``internlm_ems5_light`` and ``falcon`` fail once the model is built
  (placed with LLaMA's partition specs); ``--cache_tower_features`` on a
  non-ens5 type fails its assert: the port refuses each with
  ``ValueError`` before loading anything.

Tolerances: the epoch's mean loss 1e-4 (float32 on both sides); a QLoRA
run of one step per epoch (its loss does not depend on the adapters' A,
which each package draws from its own generator) 1e-4; the cached
features 1e-4 of the largest, the cached step's loss bit for bit with the
uncached one and 1e-4 from the JAX forward's."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image
from test_torch_eval import tiny_towers  # noqa: F401
from test_torch_families_eval import ckpts, tiny_configs  # noqa: F401
from test_torch_feature_cache import _Batches

from a3vlm_tpu import main_finetune as jfinetune
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import ens5_2images as je2
from a3vlm_tpu.train import feature_cache as jcache
from a3vlm_tpu.train.losses import next_token_loss as jloss
from a3vlm_tpu_torch import main_finetune as tfinetune
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.train import feature_cache as tcache

torch.set_num_threads(1)
ATOL = 1e-4
SIZE = 56  # the tiny towers' image size
FALCON_TINY = dict(num_layers=2, hidden_size=64, num_attention_heads=4,
                   num_kv_heads=2)


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """Two data configs of 4 dialog items: text only, and with an
    image."""
    d = tmp_path_factory.mktemp("data")
    img = d / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 64, 3)).astype(np.uint8)).save(img)
    out = {}
    for name, image in (("text", None), ("image", str(img))):
        records = [{"conversations": [
            {"from": "human", "value": f"Where is door {i}?"},
            {"from": "gpt", "value": f"door {i} here"}]} for i in range(4)]
        if image:
            for r in records:
                r["image"] = image
        (d / f"{name}.json").write_text(json.dumps(records))
        cfg = d / f"{name}.yaml"
        cfg.write_text(f"META:\n - path: {d / (name + '.json')}\n"
                       "   type: image_text\n")
        out[name] = str(cfg)
    return out


def _argv(tok_dir, data_cfg, family, *extra):
    return ["--llama_type", family, "--tokenizer_path", tok_dir,
            "--data_config", data_cfg, "--dialog", "--epochs", "1",
            "--warmup_epochs", "0", "--lr", "1e-3", "--precision", "fp32",
            "--print_freq", "1", *extra]


def _closs(out_dir) -> dict:
    return json.loads((out_dir / "log.txt").read_text().splitlines()[0])


@pytest.mark.parametrize("family,mode", [
    ("llama", "full"), ("llama", "qlora"),
    ("llama_ens5_2images", "full"), ("llama_ens5_2images", "qlora")])
def test_finetune_trains_as_the_jax_cli(tiny_configs, ckpts, data,  # noqa
                                        tiny_tokenizer_dir, tmp_path,
                                        family, mode):
    """``full``: two steps of batch 2 from the checkpoint; ``qlora``:
    ``--quant --lora_rank 4 --only_save_trainable`` (and, for the 2-image
    model, ``--cache_tower_features``, which passes text-only batches
    through), one step of batch 4. The epoch's loss equals the JAX
    CLI's."""
    d = ckpts[family][0]
    data_cfg = data["image" if family == "llama" else "text"]
    extra = ["--pretrained_path", str(d), "--max_words", "128"]
    if mode == "full":
        extra += ["--batch_size", "2"]
    else:
        extra += ["--batch_size", "4", "--quant", "--lora_rank", "4",
                  "--only_save_trainable"]
        if family == "llama_ens5_2images":
            extra.append("--cache_tower_features")
    argv = _argv(tiny_tokenizer_dir, data_cfg, family, *extra)
    jfinetune.main(argv + ["--output_dir", str(tmp_path / "j"),
                           "--num_devices", "1"])
    state = tfinetune.main(argv + ["--output_dir", str(tmp_path / "t"),
                                   "--device", "cpu"])
    assert state.step == (2 if mode == "full" else 1)
    want, got = _closs(tmp_path / "j"), _closs(tmp_path / "t")
    assert abs(got["closs"] - want["closs"]) < ATOL, (got, want)
    if mode == "full":
        assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-3 * max(
            1.0, want["grad_norm"]), (got, want)
    else:
        assert "lora" in state.params


def test_2images_image_batches_fail_as_the_jax_cli(tiny_configs, ckpts,  # noqa
                                                   data, tiny_tokenizer_dir,
                                                   tmp_path):
    """Data with images: neither CLI's dataset loads a depth stream, so
    the 2-image forward refuses the first batch in both."""
    argv = _argv(tiny_tokenizer_dir, data["image"], "llama_ens5_2images",
                 "--pretrained_path", str(ckpts["llama_ens5_2images"][0]),
                 "--max_words", "512", "--batch_size", "2")
    with pytest.raises(AssertionError, match="depth stream"):
        jfinetune.main(argv + ["--output_dir", str(tmp_path / "j"),
                               "--num_devices", "1"])
    with pytest.raises(ValueError, match="depth stream"):
        tfinetune.main(argv + ["--output_dir", str(tmp_path / "t"),
                               "--device", "cpu"])


@pytest.mark.parametrize("case", ["internlm_ems5_light", "falcon",
                                  "llama_cache"])
def test_finetune_refuses_where_the_jax_cli_fails(tiny_configs, ckpts,  # noqa
                                                  data, tiny_tokenizer_dir,
                                                  tmp_path, case):
    """The JAX CLI builds the model and fails placing it (a key mismatch
    against LLaMA's partition specs), or fails its ens5-only assert for
    ``--cache_tower_features``; the port raises ``ValueError`` before it
    reads the checkpoint or builds anything (its ``--pretrained_path``
    here does not exist)."""
    if case == "falcon":
        cfg = tmp_path / "falcon.json"
        cfg.write_text(json.dumps(FALCON_TINY))
        jextra = ["--llama_config", str(cfg)]
        family, error, match = "falcon", ValueError, "key mismatch"
    elif case == "internlm_ems5_light":
        jextra = ["--pretrained_path", str(ckpts[case][0])]
        family, error, match = case, ValueError, "key mismatch"
    else:
        jextra = ["--pretrained_path", str(ckpts["llama"][0]),
                  "--cache_tower_features"]
        family, error, match = "llama", AssertionError, "ens5-family only"
    argv = _argv(tiny_tokenizer_dir, data["text"], family, "--max_words",
                 "128", "--batch_size", "2")
    with pytest.raises(error, match=match):
        jfinetune.main(argv + jextra + ["--output_dir", str(tmp_path / "j"),
                                        "--num_devices", "1"])
    textra = ["--pretrained_path", str(tmp_path / "no_such_checkpoint")]
    if case == "llama_cache":
        textra.append("--cache_tower_features")
    with pytest.raises(ValueError, match="ens5-family only|does not train"):
        tfinetune.main(argv + textra + ["--output_dir", str(tmp_path / "t"),
                                        "--device", "cpu"])
    assert not (tmp_path / "t").exists()


def _images(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def rgbd():
    """A tiny 2-image tree from numpy, in each package (float32)."""
    jcfg = jens5.tiny_ens5_config(vocab_size=128)
    shapes = jax.eval_shape(lambda k: je2.init_params(k, jcfg),
                            jax.random.PRNGKey(7))
    rng = np.random.default_rng(4)
    tree = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        shapes)
    return jcfg, tree, params_from_numpy(tree, device="cpu")


def _rgbd_batches():
    ex = np.ones((2, 8), np.int64)
    return [
        {"examples": ex, "image": _images(2, 1), "depth_image": _images(2, 2),
         "_indices": np.array([0, 1])},
        {"examples": np.stack([ex, ex]),
         "_indices": np.array([[2, 3], [4, 5]]),
         "image": _images(4, 3).reshape(2, 2, SIZE, SIZE, 3),
         "depth_image": _images(4, 4).reshape(2, 2, SIZE, SIZE, 3)},
        {"examples": ex, "_indices": np.array([6, 7])},
    ]


def test_feature_caching_loader_depth_stream_matches_jax(rgbd):
    """``FeatureCachingLoader(depth_cache=)``: both streams of plain and
    accumulation batches swapped for their features, a text-only batch
    through as it is, the features equal to the JAX loader's; the next
    epoch runs no tower; a depth batch without a depth cache raises."""
    jcfg, tree, tparams = rgbd
    batches = _rgbd_batches()
    jl = jcache.FeatureCachingLoader(
        _Batches(batches), jcache.TowerFeatureCache(tree, jcfg),
        depth_cache=jcache.TowerFeatureCache(tree, jcfg))
    tl = tcache.FeatureCachingLoader(
        _Batches(batches), tcache.TowerFeatureCache(tparams,
                                                    tiny_ens5_config()),
        depth_cache=tcache.TowerFeatureCache(tparams, tiny_ens5_config()))
    want, got = list(jl), list(tl)
    assert tl.cache.computed == jl.cache.computed == 3
    assert tl.depth_cache.computed == jl.depth_cache.computed == 3
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        for k, v in w.items():
            v = np.asarray(v, np.float32)
            gv = g[k].float().numpy() if isinstance(g[k], torch.Tensor) \
                else np.asarray(g[k], np.float32)
            assert gv.shape == v.shape, k
            np.testing.assert_allclose(gv, v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1))
    assert "depth_image" not in got[0] and got[1]["depth_feat_q"].shape[
        :2] == (2, 10)
    again = list(tl)
    assert tl.cache.computed == tl.depth_cache.computed == 3
    for a, b in zip(again, got):
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k])
    bare = tcache.FeatureCachingLoader(_Batches(batches[:1]), tl.cache)
    with pytest.raises(ValueError, match="depth_cache"):
        list(bare)


def test_2images_loss_takes_the_depth_stream(rgbd):
    """The CLI's loss (``make_loss_fn``) over a 2-image batch: with the raw
    streams equal to the JAX 2-image forward's loss, and bit for bit the
    same over the features the depth-caching loader swapped in."""
    jcfg, tree, tparams = rgbd
    model = MetaModel("llama_ens5_2images", params=tparams,
                      model_cfg=tiny_ens5_config(), vocab_size=128,
                      with_visual=True, device="cpu")
    ex = np.random.default_rng(6).integers(3, 120, size=(2, 12))
    ex[:, 0] = 1
    labels = ex.copy()
    labels[:, :3] = 0
    img, dep = _images(2, 8), _images(2, 9)
    want = float(jloss(je2.forward(
        jax.tree_util.tree_map(jnp.asarray, tree), jcfg, jnp.asarray(ex),
        image=jnp.asarray(img), depth_image=jnp.asarray(dep)),
        jnp.asarray(labels), vocab_size=128))
    loss_fn = tfinetune.make_loss_fn(model, torch.float32, remat=False)
    raw = {"examples": ex, "labels": labels, "image": img,
           "depth_image": dep}
    with torch.no_grad():
        got = loss_fn(tparams, tfinetune.batch_to_device(
            raw, "cpu", torch.float32))
        assert abs(float(got) - want) < ATOL
        cached = next(iter(tcache.FeatureCachingLoader(
            _Batches([{**raw, "_indices": np.array([0, 1])}]),
            tcache.TowerFeatureCache(tparams, tiny_ens5_config()),
            depth_cache=tcache.TowerFeatureCache(tparams,
                                                 tiny_ens5_config()))))
        assert "depth_feat_ens" in cached and "depth_image" not in cached
        again = loss_fn(tparams, tfinetune.batch_to_device(
            cached, "cpu", torch.float32))
    assert torch.equal(again, got)
