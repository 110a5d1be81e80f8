"""The port's tower-feature cache and layer-wise update scales against the
JAX package: a cached train step against an uncached one, the ``.npz``
spill read across the packages, ``FeatureCachingLoader`` with gradient
accumulation and pass-through batches, the training CLI with
``--cache_tower_features``, and ``layerwise_scale_tree`` with the AdamW
hook against optax.

Tolerances: cached against uncached bit for bit (the same features, bf16,
the same operations); the spill files exactly (they only move bytes); the
port's towers against JAX's in float32 to 1e-4 of the largest feature;
the update scales and the optimizer to 1e-6 (float32 powers and products
in another order)."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.train import feature_cache as jcache
from a3vlm_tpu.train import param_groups as jgroups
from a3vlm_tpu_torch import main_finetune as tfinetune
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy, params_to_numpy
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.main_finetune import make_loss_fn, qlora_trainable_mask
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.train import feature_cache as tcache
from a3vlm_tpu_torch.train import param_groups as tgroups
from a3vlm_tpu_torch.train.lora import init_lora_params
from a3vlm_tpu_torch.train.step import (
    AdamW,
    TrainState,
    make_train_step,
    tree_leaves,
)
from a3vlm_tpu_torch.utils.tensor_type import mixed_precision_policy

torch.set_num_threads(1)
SIZE = 56  # the tiny towers' image size


@pytest.fixture(scope="module")
def towers():
    """The tiny llama_ens5 tree from numpy, in each package (float32)."""
    jcfg = jens5.tiny_ens5_config(vocab_size=128)
    shapes = jax.eval_shape(lambda k: jens5.init_ens5_params(k, jcfg),
                            jax.random.PRNGKey(7))
    rng = np.random.default_rng(3)
    tree = jax.tree_util.tree_map(
        lambda s: (0.05 * rng.normal(size=s.shape)).astype(np.float32),
        shapes)
    return jcfg, tree, params_from_numpy(tree, device="cpu")


def _images(n, seed):
    return np.random.default_rng(seed).normal(
        size=(n, SIZE, SIZE, 3)).astype(np.float32)


def test_cached_step_equals_uncached():
    """Two train steps of the QLoRA recipe in bf16 over float32 masters,
    once with the image and once with the cache's features of it: the
    losses, every trainable leaf and both moments bit for bit."""
    results = []
    for cached in (False, True):
        model = MetaModel("llama_ens5", with_visual=True, max_seq_len=128,
                          vocab_size=100, model_cfg=tiny_ens5_config(),
                          device="cpu", seed=0)
        model.quantize(bits=4)
        lora = init_lora_params(torch.Generator().manual_seed(17),
                                model.params["llama"], rank=4)
        mask = qlora_trainable_mask(model, lora, quant=True)
        model.params = mixed_precision_policy(model.params, mask,
                                              torch.bfloat16)
        cache = tcache.TowerFeatureCache(model.params, model.cfg)
        step = make_train_step(make_loss_fn(model, torch.bfloat16,
                                            remat=False),
                               AdamW(1e-3), trainable_mask=mask)
        state = TrainState.create({**model.params, "lora": lora},
                                  AdamW(1e-3), mask)
        losses = []
        for seed in (1, 2):
            r = np.random.default_rng(seed)
            ex = torch.from_numpy(r.integers(3, 100, size=(2, 12)))
            ex[:, 0] = 1
            batch = {"examples": ex, "labels": ex.clone()}
            images = _images(2, seed)
            if cached:
                f = cache.get_batch([seed, seed + 10], images)
                assert f["q"].dtype == torch.bfloat16
                batch.update(image_feat_q=f["q"], image_feat_ens=f["ens"])
            else:
                batch["image"] = torch.from_numpy(images).to(torch.bfloat16)
            state, m = step(state, batch)
            losses.append(float(m["loss"]))
        results.append((losses, tree_leaves(state.params["lora"])
                        + tree_leaves(state.params["visual_proj"])
                        + tree_leaves(state.opt_state.mu)
                        + tree_leaves(state.opt_state.nu)))
    (l0, a), (l1, b) = results
    assert l0 == l1
    assert len(a) == len(b) and all(torch.equal(x, y) for x, y in zip(a, b))


def test_cache_files_cross_packages(towers, tmp_path):
    """A cache the JAX package spilled (bf16 as a uint16 view) is read by
    the port as it stored it, and one the port spilled by the JAX
    package; a hit replays exactly what the miss returned."""
    jcfg, tree, tparams = towers
    jbf16 = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.bfloat16),
                                   tree)
    jc = jcache.TowerFeatureCache(jbf16, jcfg, cache_dir=str(tmp_path / "j"))
    images = _images(2, 5)
    want = jc.get_batch([3, 7], images)
    assert want["q"].dtype == jnp.bfloat16
    tbf16 = params_from_numpy(tree, device="cpu", dtype=torch.bfloat16)
    tc = tcache.TowerFeatureCache(tbf16, tiny_ens5_config(),
                                  cache_dir=str(tmp_path / "j"))
    got = tc.get_batch([3, 7], None)  # all hits: the JAX files
    assert tc.computed == 0
    assert want["ens"].dtype == np.float32  # the JAX ensemble's promotion
    for k in ("q", "ens"):
        assert str(got[k].dtype) == f"torch.{want[k].dtype}"
        np.testing.assert_array_equal(got[k].float().numpy(),
                                      np.asarray(want[k], np.float32))

    tw = tcache.TowerFeatureCache(tbf16, tiny_ens5_config(),
                                  cache_dir=str(tmp_path / "t"))
    made = tw.get_batch([3, 7], images)
    assert tw.computed == 1
    back = jcache.TowerFeatureCache(jbf16, jcfg,
                                    cache_dir=str(tmp_path / "t"))
    read = back.get_batch([3, 7], None)
    assert back.computed == 0
    for k in ("q", "ens"):
        np.testing.assert_array_equal(np.asarray(read[k], np.float32),
                                      made[k].float().numpy())
        assert torch.equal(tw.get_batch([3, 7], None)[k], made[k])
    # the port's features of the same towers, against the JAX ones
    for k in ("q", "ens"):
        np.testing.assert_allclose(made[k].float().numpy(),
                                   np.asarray(want[k], np.float32),
                                   rtol=0, atol=0.05 * float(
                                       np.abs(np.asarray(want[k],
                                                         np.float32)).max()))


class _Batches:
    def __init__(self, batches):
        self.batches = batches
        self.closed = False

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        for b in self.batches:
            yield {k: v.copy() for k, v in b.items()}

    def close(self):
        self.closed = True


def test_feature_caching_loader_matches_jax(towers):
    """Plain and accumulation ([accum, bs]) batches swap ``image`` for the
    features; a text-only batch and a ``depth_image``-only batch pass
    through as they are; the second epoch runs no tower; the features
    equal the JAX loader's to 1e-4 of the largest."""
    jcfg, tree, tparams = towers
    ex = np.ones((2, 8), np.int64)
    batches = [
        {"examples": ex, "image": _images(2, 1),
         "_indices": np.array([0, 1])},
        {"examples": np.stack([ex, ex]), "_indices": np.array([[2, 3],
                                                               [4, 5]]),
         "image": _images(4, 2).reshape(2, 2, SIZE, SIZE, 3)},
        {"examples": ex, "_indices": np.array([6, 7])},
        {"examples": ex, "depth_image": _images(2, 3),
         "_indices": np.array([8, 9])},
    ]
    jl = jcache.FeatureCachingLoader(_Batches(batches),
                                     jcache.TowerFeatureCache(tree, jcfg))
    tl = tcache.FeatureCachingLoader(
        _Batches(batches), tcache.TowerFeatureCache(tparams,
                                                    tiny_ens5_config()))
    assert len(tl) == len(jl) == 4
    want, got = list(jl), list(tl)
    assert tl.cache.computed == jl.cache.computed == 3
    for w, g in zip(want, got):
        assert g.keys() == w.keys()
        for k, v in w.items():
            v = np.asarray(v, np.float32)
            gv = g[k].float().numpy() if isinstance(g[k], torch.Tensor) \
                else np.asarray(g[k], np.float32)
            assert gv.shape == v.shape, k
            np.testing.assert_allclose(gv, v, rtol=0,
                                       atol=1e-4 * max(np.abs(v).max(), 1))
    assert "image" not in got[0] and got[1]["image_feat_q"].shape[:2] == (
        2, 10)
    np.testing.assert_array_equal(got[3]["depth_image"], batches[3][
        "depth_image"])
    again = list(tl)  # the next epoch: every batch a hit
    assert tl.cache.computed == 3
    for a, b in zip(again, got):
        for k in a:
            if isinstance(a[k], torch.Tensor):
                assert torch.equal(a[k], b[k])
    tl.close()
    assert tl.loader.closed
    bare = tcache.FeatureCachingLoader(_Batches([
        {"examples": ex, "image": _images(2, 1)}]), tl.cache)
    with pytest.raises(ValueError, match="with_indices"):
        list(bare)


def test_cli_cache_tower_features(tiny_tokenizer_dir, tmp_path):
    """``main_finetune --cache_tower_features`` (spilled to
    ``--feature_cache_dir``) gives the uncached run's log bit for bit over
    two epochs, and a resumed run replays the spilled features."""
    img = tmp_path / "img.png"
    Image.fromarray(np.random.default_rng(0).integers(
        0, 255, (48, 64, 3)).astype(np.uint8)).save(img)
    (tmp_path / "tasks.json").write_text(json.dumps([
        {"image": str(img), "conversations": [
            {"from": "human", "value": f"Where is door {i}?"},
            {"from": "gpt", "value": f"door {i} here"}]} for i in range(4)]))
    cfg = tmp_path / "data.yaml"
    cfg.write_text(f"META:\n - path: {tmp_path / 'tasks.json'}\n"
                   "   type: image_text\n")
    argv = ["--tokenizer_path", tiny_tokenizer_dir, "--data_config",
            str(cfg), "--dialog", "--tiny_random_model", "--quant",
            "--lora_rank", "4", "--only_save_trainable", "--batch_size", "2",
            "--epochs", "2", "--warmup_epochs", "0", "--lr", "1e-3",
            "--max_words", "128", "--device", "cpu", "--print_freq", "100"]
    feats = tmp_path / "features"
    logs = {}
    for name, extra in (("plain", []),
                        ("cached", ["--cache_tower_features",
                                    "--feature_cache_dir", str(feats)])):
        tfinetune.main(argv + extra + ["--output_dir", str(tmp_path / name)])
        logs[name] = (tmp_path / name / "log.txt").read_text()
    assert logs["cached"] == logs["plain"]
    assert sorted(p.name for p in feats.iterdir()) == [
        f"feat_{i}.npz" for i in range(4)]


def test_layerwise_scales_match_jax(towers):
    """``layerwise_scale_tree`` on the port's tree against the JAX
    function on the stacked tree (the decoder's layers per layer, the
    embeddings decay^24, the rest 1), and ``AdamW(update_scales=...)``
    against ``optax.chain(clip, adamw, scale_updates_by)``."""
    _, tree, tparams = towers
    want = jgroups.layerwise_scale_tree(tree["llama"], 0.8)
    got = tgroups.layerwise_scale_tree(tparams["llama"], 0.8)
    assert len(got["layers"]) == 2
    stacked = params_to_numpy({"layers": got["layers"]})["layers"]
    for path, w in jax.tree_util.tree_flatten_with_path(want["layers"])[0]:
        g = stacked
        for p in path:
            g = g[p.key]
        # one scalar a layer here, [L, 1, ...] in the JAX tree
        assert g.shape == (2,)
        np.testing.assert_allclose(g.reshape(np.shape(w)), np.asarray(w),
                                   rtol=1e-6, atol=0)
    for key in ("tok_embeddings", "norm", "output"):
        np.testing.assert_allclose(float(got[key]["weight"]),
                                   float(want[key]["weight"]), rtol=1e-6)
    assert float(got["tok_embeddings"]["weight"]) == pytest.approx(0.8 ** 24)

    # the hook: two updates of the decoder tree, scaled per layer (no
    # weight decay, the recipe's: the JAX mask ndim > 1 also takes the
    # stacked [L, D] norms, which are [D] a layer here)
    rng = np.random.default_rng(9)
    grads = [jax.tree_util.tree_map(
        lambda x: rng.normal(size=np.shape(x)).astype(np.float32),
        tree["llama"]) for _ in range(2)]
    opt = optax.chain(optax.clip_by_global_norm(1.0),
                      optax.adamw(1e-2, b1=0.9, b2=0.95, weight_decay=0.0,
                                  mask=lambda p: jax.tree_util.tree_map(
                                      lambda x: x.ndim > 1, p)),
                      jgroups.scale_updates_by(want))
    jp = jax.tree_util.tree_map(jnp.asarray, tree["llama"])
    st = opt.init(jp)
    for g in grads:
        upd, st = opt.update(jax.tree_util.tree_map(jnp.asarray, g), st, jp)
        jp = optax.apply_updates(jp, upd)
    tp = params_from_numpy({"llama": tree["llama"]}, device="cpu")["llama"]
    adam = AdamW(1e-2, max_grad_norm=1.0, update_scales=got)
    ost = adam.init(tp)
    for g in grads:
        tg = params_from_numpy({"llama": g}, device="cpu")["llama"]
        ost, _ = adam.update(tg, ost, tp)
    back = params_to_numpy({"llama": tp})["llama"]
    for (path, w), (_, v) in zip(
            jax.tree_util.tree_flatten_with_path(jp)[0],
            jax.tree_util.tree_flatten_with_path(back)[0]):
        np.testing.assert_allclose(v, np.asarray(w), rtol=0, atol=1e-6,
                                   err_msg=str(path))
