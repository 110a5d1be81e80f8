"""The model families of the PyTorch port beside ``llama_ens5`` against the
JAX package on tiny configs in float32: ``internlm_ems5_light`` (here),
``llama_ens5_2images`` and text-only ``llama``
(``test_torch_families_rgbd.py``, which runs these tests over those two).
The same numpy weights go to both packages (``params_from_numpy``), and
both see the same images, depth images and prompts.

Tolerances: image tokens, prefill and decode logits and ``compute_logits``
1e-4 (float32 on both sides; only summation order and transcendental
rounding differ); the training loss 1e-5; the two-scale crops 1e-5 (the
same resize weights, applied in another order); greedy token ids and
decoded strings identical in every generation mode; the trainable masks
and quantization blocklists equal."""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.meta import MetaModel as JMetaModel
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import ens5_2images as je2
from a3vlm_tpu.models import internlm_ems5_light as jil
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import tiny_ens5_config
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import internlm_ems5_light as til
from a3vlm_tpu_torch.models import llama as tllama

torch.set_num_threads(1)
ATOL = 1e-4
PROMPTS = ["### Human: please provide the joint's type",
           "detect all manipulable object parts and provide their rotated "
           "bounding boxes"]
# the tiny text-only decoder: grouped-query attention and InternLM2's rope
# theta, so the llama family also runs 2 query heads a kv head
LLAMA_TINY = dict(dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
                  multiple_of=16, rope_theta=1e6)


class _Recording:
    """Tokenizer proxy that records the id lists passed to decode."""

    def __init__(self, tok):
        self._tok = tok
        self.decoded = []

    def decode(self, ids):
        self.decoded.append(list(ids))
        return self._tok.decode(ids)

    def __getattr__(self, name):
        return getattr(self._tok, name)


def numpy_tree(init, cfg, seed: int):
    """A JAX init's tree shape, filled from a seeded numpy generator (the
    JAX package's eager init takes tens of seconds here)."""
    rng = np.random.default_rng(seed)
    shapes = jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))
    return jax.tree_util.tree_map(
        lambda x: (1.0 + 0.1 * rng.standard_normal(x.shape)
                   if len(x.shape) == 1 else
                   0.05 * rng.standard_normal(x.shape)).astype(np.float32),
        shapes)


def family_configs(family: str, vocab: int, tmp_path_factory):
    """(JAX model_cfg, port model_cfg, llama_config, image size, tree) of
    a family's tiny config. ``llama``'s decoder comes from a config file,
    which both constructors read (the JAX one takes no model_cfg there)."""
    if family == "internlm_ems5_light":
        jcfg = jil.tiny_config(vocab)
        return (jcfg, til.tiny_config(vocab), None, jcfg.image_size,
                numpy_tree(jil.init_params, jcfg, 21))
    if family == "llama_ens5_2images":
        jcfg = jens5.tiny_ens5_config(vocab)
        return (jcfg, tiny_ens5_config(vocab), None, jcfg.image_size,
                numpy_tree(je2.init_params, jcfg, 22))
    path = tmp_path_factory.mktemp("llama_cfg") / "config.json"
    path.write_text(json.dumps(LLAMA_TINY))
    args = JModelArgs(vocab_size=vocab, max_seq_len=512, **LLAMA_TINY)
    return (None, None, [str(path)], None,
            numpy_tree(jllama.init_llama_params, args, 23))


def build_pair(family: str, tok, tmp_path_factory, quant: bool) -> dict:
    vocab = -(-tok.n_words // 128) * 128
    jcfg, tcfg, llama_config, size, tree = family_configs(
        family, vocab, tmp_path_factory)
    jrec, trec = _Recording(tok), _Recording(tok)
    jm = JMetaModel(family, llama_config=llama_config, with_visual=True,
                    max_seq_len=512, dtype=jnp.float32,
                    params=jax.tree_util.tree_map(jnp.asarray, tree),
                    tokenizer=jrec, model_cfg=jcfg)
    tm = MetaModel(family, llama_config=llama_config, with_visual=True,
                   max_seq_len=512, params=params_from_numpy(tree,
                                                             device="cpu"),
                   tokenizer=trec, model_cfg=tcfg, device="cpu")
    if quant:
        jm.quantize(bits=4)
        tm.quantize(bits=4)
    rng = np.random.default_rng(5)
    images = depth = None
    if size:
        images = rng.normal(size=(2, size, size, 3)).astype(np.float32)
        if family == "llama_ens5_2images":
            depth = rng.normal(size=(2, size, size, 3)).astype(np.float32)
    return {"family": family, "jm": jm, "tm": tm, "jrec": jrec, "trec": trec,
            "tok": tok, "images": images, "depth": depth}


@pytest.fixture(scope="module", params=["internlm_ems5_light"])
def family(request):
    return request.param


@pytest.fixture(scope="module")
def dense(family, tiny_tokenizer, tmp_path_factory):
    return build_pair(family, tiny_tokenizer, tmp_path_factory, quant=False)


@pytest.fixture(scope="module")
def int4(family, tiny_tokenizer, tmp_path_factory):
    return build_pair(family, tiny_tokenizer, tmp_path_factory, quant=True)


def _t(x):
    return None if x is None else torch.tensor(x)


def image_tokens(s):
    """(JAX, port) image tokens of the pair's images, [2, words, D]."""
    jm, tm = s["jm"], s["tm"]
    if s["family"] == "llama_ens5_2images":
        want = jm.encode_images(s["images"], s["depth"])
        got = tm.encode_images(_t(s["images"]), _t(s["depth"]))
    else:
        want = jm.encode_images(s["images"])
        got = tm.encode_images(_t(s["images"]))
    return np.asarray(want), got


def test_image_tokens_match(dense):
    if dense["images"] is None:
        # text only: the JAX method fails for want of a tower module, the
        # port's refuses
        image = np.zeros((1, 56, 56, 3), np.float32)
        with pytest.raises(AttributeError):
            dense["jm"].encode_images(image)
        with pytest.raises(ValueError, match="takes no images"):
            dense["tm"].encode_images(torch.tensor(image))
        return
    want, got = image_tokens(dense)
    words = dense["tm"].image_words
    assert got.shape == want.shape == (2, words, 64)
    assert words == dense["jm"].image_words
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    if dense["family"] == "llama_ens5_2images":
        # without the depth stream both refuse (meta.py:432-435)
        with pytest.raises(AssertionError, match="depth"):
            dense["jm"].encode_images(dense["images"])
        with pytest.raises(ValueError, match="depth"):
            dense["tm"].encode_images(_t(dense["images"]))


def _prefill_decode(s):
    """Prefill of 9 text ids after the images (if any), then one decode
    step, in both packages: (JAX logits, port logits) of each."""
    jm, tm = s["jm"], s["tm"]
    tokens = np.random.default_rng(1).integers(3, 300, size=(2, 9))
    tokens[:, 0] = 1
    jimg, timg = (None, None) if s["images"] is None else image_tokens(s)
    W = 0 if jimg is None else jimg.shape[1]
    S = 9 + W
    jcache = jllama.KVCache.create(jm.args, 2, max_seq_len=S + 1,
                                   dtype=jnp.float32, layered=True)
    jp = jllama.unstack_layers(jm._decoder_params())
    # jitted: one compile in place of one for every op
    want, jcache, _ = jax.jit(jllama.prefill, static_argnums=1)(
        jp, jm.args, jcache, jnp.asarray(tokens),
        image_tokens=None if jimg is None else jnp.asarray(jimg))
    tcache = tllama.KVCache.create(tm.args, 2, max_seq_len=S + 1,
                                   dtype=torch.float32, device="cpu")
    with torch.inference_mode():
        got, tcache, n = tllama.prefill(tm._decoder_params(), tm.args, tcache,
                                        torch.tensor(tokens), timg)
    assert n == S
    nxt = np.array([[5], [6]])
    want_d, _ = jax.jit(jllama.decode_step, static_argnums=1)(
        jp, jm.args, jcache, jnp.asarray(nxt), S)
    with torch.inference_mode():
        got_d, _ = tllama.decode_step(tm._decoder_params(), tm.args, tcache,
                                      torch.tensor(nxt), S)
    return (np.asarray(want), got.numpy()), (np.asarray(want_d),
                                             got_d.numpy())


def test_prefill_and_decode_logits_match(dense):
    assert dense["tm"].args == _port_args(dense["jm"].args)
    for want, got in _prefill_decode(dense):
        assert got.shape == want.shape == (2, dense["tm"].args.vocab_size)
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def test_int4_prefill_logits_match(int4):
    """``quantize(4)``: the same packed weights, the same logits."""
    for want, got in _prefill_decode(int4):
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _port_args(jargs):
    from a3vlm_tpu_torch.config import ModelArgs

    return ModelArgs(**{f: getattr(jargs, f)
                        for f in ModelArgs.__dataclass_fields__})


def test_compute_logits_match(dense):
    jm, tm = dense["jm"], dense["tm"]
    texts = ["hello door", "the answer is <rb>revolute</rb>"]
    for a, b in zip(tm.compute_logits(texts), jm.compute_logits(texts)):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    if dense["images"] is None:
        return
    images = dense["images"]
    if dense["family"] == "llama_ens5_2images":
        # the JAX method takes no depth stream and fails; the port's takes
        # it and equals the JAX forward over the JAX image tokens
        with pytest.raises(AssertionError, match="depth"):
            jm.compute_logits(texts, images=images)
        with pytest.raises(ValueError, match="depth"):
            tm.compute_logits(texts, images=images)
        got = tm.compute_logits(texts, images=images,
                                depth_images=dense["depth"])
        toks = [jm.tokenizer.encode(t, True, False) for t in texts]
        L = max(map(len, toks))
        arr = np.zeros((2, L), np.int32)
        for i, t in enumerate(toks):
            arr[i, :len(t)] = t
        full = np.asarray(jllama.forward_train(
            jm._decoder_params(), jm.args, jnp.asarray(arr),
            image_tokens=jm.encode_images(images, dense["depth"])))
        want = [full[i, :len(t), :tm.true_vocab] for i, t in enumerate(toks)]
    else:
        want = jm.compute_logits(texts, images=images)
        got = tm.compute_logits(texts, images=images)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)


def test_forward_loss_matches(dense):
    jm, tm = dense["jm"], dense["tm"]
    rng = np.random.default_rng(3)
    examples = rng.integers(3, 300, size=(2, 12))
    examples[:, 0] = 1
    labels = examples.copy()
    labels[:, :4] = 0
    kw_j, kw_t = {}, {}
    if dense["images"] is not None:
        kw_j["images"], kw_t["images"] = dense["images"], _t(dense["images"])
    if dense["depth"] is not None:
        kw_j["depth_images"] = dense["depth"]
        kw_t["depth_images"] = _t(dense["depth"])
    want = float(jm.forward(jnp.asarray(examples), jnp.asarray(labels),
                            **kw_j))
    got = tm.forward(torch.tensor(examples), torch.tensor(labels), **kw_t)
    assert abs(float(got) - want) <= 1e-5


def test_masks_and_blocklist_equal_jax(dense):
    """``get_trainable_params`` (all leaves trainable for
    ``internlm_ems5_light`` and ``llama``, as in the JAX method) and
    ``get_quant_blocklist``."""
    jm, tm = dense["jm"], dense["tm"]
    assert tm.get_quant_blocklist() == jm.get_quant_blocklist()
    want = {k: sorted(set(jax.tree_util.tree_leaves(v)))
            for k, v in jm.get_trainable_params().items()}
    mask = tm.get_trainable_params()
    got = {k: sorted(set(_bools(v))) for k, v in mask.items()}
    if dense["family"] == "llama":  # a bare decoder: compare every key
        assert got == {k: [True] for k in want}
    assert got == want


def _bools(tree):
    if isinstance(tree, dict):
        return [b for v in tree.values() for b in _bools(v)]
    if isinstance(tree, (list, tuple)):
        return [b for v in tree for b in _bools(v)]
    return [] if tree is None else [tree]


def test_stream_generate_ends_as_generate(dense):
    """``stream_generate`` (with ``depth_image`` for the 2-image model,
    which the JAX method cannot take) ends on ``generate``'s greedy text;
    where the JAX method runs, its text is the same."""
    jm, tm = dense["jm"], dense["tm"]
    kw = {}
    if dense["images"] is not None:
        kw["image"] = dense["images"][0]
    if dense["depth"] is not None:
        kw["depth_image"] = dense["depth"][0]
    chunks = list(tm.stream_generate("hello door", max_gen_len=8, **kw))
    assert chunks[-1]["end_of_content"]
    assert all(not c["end_of_content"] for c in chunks[:-1])
    want = tm.generate(["hello door"], max_gen_len=8,
                       images=None if "image" not in kw
                       else kw["image"][None],
                       depth_images=None if "depth_image" not in kw
                       else kw["depth_image"][None])[0]
    assert chunks[-1]["text"] == want
    if dense["family"] != "llama_ens5_2images":
        jchunks = list(jm.stream_generate("hello door", max_gen_len=8,
                                          image=kw.get("image")))
        assert jchunks[-1]["text"] == chunks[-1]["text"]


def test_load_lora_and_adapter_checkpoint_match_jax(dense, tmp_path):
    """Adapters on each family's decoder (a bare tree for ``llama``,
    ``params["llama"]`` for the others), served unmerged, give the JAX
    method's logits; from a trainable-only checkpoint of the port, merged
    into the dense decoder, the same within float32 rounding."""
    from a3vlm_tpu.train import lora as jlora
    from a3vlm_tpu_torch.checkpoint.manager import CheckpointManager

    jm, tm = dense["jm"], dense["tm"]
    decoder = jm.params if dense["family"] == "llama" else jm.params["llama"]
    lora = jlora.init_lora_params(jax.random.PRNGKey(5), decoder, rank=4)
    rng = np.random.default_rng(9)
    lora = jax.tree_util.tree_map(lambda x: np.asarray(x) + rng.normal(
        scale=0.05, size=x.shape).astype(np.float32), lora)
    texts = ["hello door", "open the drawer please"]
    base = tm.compute_logits(texts)
    dense_decoder = tm.decoder
    try:
        jm.load_lora(lora)
        tm.load_lora(params_from_numpy({"lora": lora}, device="cpu")["lora"])
        got = tm.compute_logits(texts)
        for a, b in zip(got, jm.compute_logits(texts)):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
        assert np.abs(got[0] - base[0]).max() > 1e-3
        tm._loras = []
        path = CheckpointManager(str(tmp_path)).save(
            0, params=params_from_numpy({"lora": lora}, device="cpu"))
        tm.load_adapter_checkpoint(path, merge=True)
        for a, b in zip(tm.compute_logits(texts), got):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=0)
    finally:
        jm._params_transform = None
        tm._loras = []
        tm._set_decoder(dense_decoder)


def _generate(s, prompts, fsms=(None, None), **kw):
    """(JAX ids, port ids, JAX strings, port strings) of one generate call
    with the pair's images (the first ``len(prompts)`` of them); ``fsms``
    the grammar of each package."""
    jm, tm = s["jm"], s["tm"]
    n = len(prompts)
    kj, kt = {}, {}
    if s["images"] is not None:
        kj["images"], kt["images"] = s["images"][:n], _t(s["images"][:n])
    if s["depth"] is not None:
        kj["depth_images"] = s["depth"][:n]
        kt["depth_images"] = _t(s["depth"][:n])
    s["jrec"].decoded.clear()
    s["trec"].decoded.clear()
    want = jm.generate(prompts, fsm=fsms[0], **kj, **kw)
    got = tm.generate(prompts, fsm=fsms[1], **kt, **kw)
    return list(s["jrec"].decoded), list(s["trec"].decoded), want, got


MODES = ("vanilla", "grammar", "kv8", "chunk", "draft_k")


@pytest.mark.parametrize("mode", MODES)
def test_generate_greedy_identical(int4, mode):
    """Greedy ``generate`` of the int4 models, ids and strings identical in
    every mode: two prompts of different lengths (one for ``draft_k``, a
    batch-1 request), under the joint grammar, with the int8 cache and with
    the chunked prefill."""
    jm, tm = int4["jm"], int4["tm"]
    kw = dict(max_gen_len=10)
    prompts = PROMPTS
    if mode == "draft_k":
        prompts, kw["draft_k"] = PROMPTS[:1], 6
    if mode == "grammar":
        kw["max_gen_len"] = 24
        kw["fsms"] = tuple(c.compile_grammar(c.joint_rec_grammar(),
                                             int4["tok"])
                           for c in (jconstrained, tconstrained))
    try:
        for m in (jm, tm):
            m.kv_cache_bits = 8 if mode == "kv8" else None
            m.prefill_chunk = 16 if mode == "chunk" else None
        want_ids, got_ids, want, got = _generate(int4, prompts, **kw)
    finally:
        for m in (jm, tm):
            m.kv_cache_bits = None
            m.prefill_chunk = None
    assert got_ids == want_ids
    assert got == want
    assert max(len(ids) for ids in got_ids) >= 4


def test_tower_bits_8_as_jax(tiny_tokenizer, tmp_path_factory,
                             monkeypatch):
    """``quantize(bits=None, tower_bits=8)``: ``internlm_ems5_light``'s
    DINOv2 and ConvNeXt linears go int8 in both packages, the same int8
    weights, and one W8A8 product on the same input is bit for bit the JAX
    one. End to end the image tokens agree to 1e-2 relative (Frobenius),
    not 1e-4: the activations round to int8 per row, so a 1e-6 difference
    upstream (a conv, a norm) that crosses a rounding boundary moves that
    product's output by one step of its row's scale, and the 128 px crops
    give ConvNeXt enough rows for such crossings. A ``llama`` model has no
    towers and both packages leave it as it was."""
    from a3vlm_tpu.ops.quant_matmul import w8a8_matmul as jw8a8
    from a3vlm_tpu_torch.ops.quant_matmul import w8a8_matmul as tw8a8

    real = jax.devices  # the JAX dispatchers' single-device path
    monkeypatch.setattr(jax, "devices", lambda *a: real(*a)[:1])
    jax.clear_caches()
    s = build_pair("internlm_ems5_light", tiny_tokenizer, tmp_path_factory,
                   quant=False)
    for m in (s["jm"], s["tm"]):
        m.quantize(bits=None, tower_bits=8)
    jw = s["jm"].params["convnext"]["stages"][0]["blocks"][0]["pw1"][
        "weight"]
    tw = s["tm"].params["convnext"]["stages"][0]["blocks"][0]["pw1"][
        "weight"]
    np.testing.assert_array_equal(tw.q.numpy(), np.asarray(jw.q))
    x = np.random.default_rng(3).normal(size=(4, 32, 32, 8)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tw8a8(torch.tensor(x), tw).numpy(),
        np.asarray(jw8a8(jnp.asarray(x), jw)))
    assert s["tm"].params["dinov2"]["blocks"]["attn"]["wqkv"][
        "weight"].q.dtype == torch.int8
    want, got = image_tokens(s)
    rel = np.linalg.norm(got.numpy() - want) / np.linalg.norm(want)
    assert rel < 1e-2, rel
    t = build_pair("llama", tiny_tokenizer, tmp_path_factory, quant=False)
    before = t["tm"].compute_logits(["hello door"])[0]
    for m in (t["jm"], t["tm"]):
        m.quantize(bits=None, tower_bits=8)
    np.testing.assert_array_equal(t["tm"].compute_logits(["hello door"])[0],
                                  before)
    jax.clear_caches()


def test_two_scale_crops_match_tiny():
    """``_two_scale_crops`` at the tiny size, per-image interleaved."""
    rng = np.random.default_rng(0)
    image = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    want = jil._two_scale_crops(jnp.asarray(image), jil.tiny_config())
    got = til._two_scale_crops(torch.tensor(image), til.tiny_config())
    for w, g in zip(want, got):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_two_scale_crops_match_at_1024():
    """The released sizes: 1024 -> 224 and 448 (DINOv2), 1024 -> 512 and
    the raw 512 quadrants (ConvNeXt); only the resizes run."""
    image = np.random.default_rng(1).normal(
        size=(1, 1024, 1024, 3)).astype(np.float32)
    want = jil._two_scale_crops(jnp.asarray(image), jil.InternlmEns5Config())
    got = til._two_scale_crops(torch.tensor(image), til.InternlmEns5Config())
    assert got[0].shape == (5, 224, 224, 3)
    assert got[1].shape == (5, 512, 512, 3)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)
    # the ConvNeXt quadrants are the raw image's, unresized
    np.testing.assert_array_equal(got[1][4].numpy(), image[0, 512:, 512:])


def test_config_and_words_equal_jax():
    """The released config: InternLM2-7B (ffn 14336, 8 kv heads, theta
    1e6), 4608 ensemble dims, 1295 image words."""
    j, t = jil.InternlmEns5Config(), til.InternlmEns5Config()
    assert t.image_words == j.image_words == 1295
    assert t.ens_dim == j.ens_dim == 4608
    assert t.llama.ffn_hidden_dim == j.llama.ffn_hidden_dim == 14336
    assert _port_args(j.llama) == t.llama
