"""The port on several ranks (``a3vlm_tpu_torch/parallel``) against the JAX
package's mesh, on the CPU: gloo ranks spawned by ``parallel.launch``, one
thread each, tiny configs in float32.

- the mesh: coordinates and collectives over each axis at data 2 x model 2
  on four ranks, grouped as the JAX ``create_mesh`` groups its devices;
- quantization for a mesh: ``quantize_params(tp_align, row_parallel)``
  byte for byte with JAX's; ``int4_chunked_geometry`` and
  ``quantized_partition_specs`` on the 13B, 7B and Falcon-180B widths at mp
  2, 4 and 8 (shapes only);
- the bridge carrying chunk-packed leaves as chunks;
- the sharded linears (dense, int4 column, int4 chunk-packed row, int8,
  replicated) against the unsharded product, the sharded decode and verify
  attention against the unsharded one, the crop-sharded towers against
  the unsharded towers;
- ``Generator(mesh=)`` at mp 4 and at data 2 x model 2 against the port
  on one rank (against JAX: tests/test_torch_parallel_generate.py).

Tolerances: products to 1e-5 and the towers' features to 1e-5 (float32;
a row-parallel product sums its partials over ranks), every rank's
output identical to rank 0's; quantized leaves byte for byte."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_families import numpy_tree

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.models import ens5 as jens5
from a3vlm_tpu.models import falcon as jfalcon
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.parallel import create_mesh as jcreate_mesh
from a3vlm_tpu_torch import quant as tquant
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import ModelArgs, tiny_ens5_config
from a3vlm_tpu_torch.models import ens5 as tens5
from a3vlm_tpu_torch.models import llama as tllama
from a3vlm_tpu_torch.ops.decode_attention import (
    make_quantized_kv,
    update_and_attend_decode_cache,
)
from a3vlm_tpu_torch.parallel import P, create_mesh
from a3vlm_tpu_torch.parallel.launch import run_spmd
from a3vlm_tpu_torch.quant import QuantizedWeight
from a3vlm_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)
ATOL = 1e-4
CPU2, CPU4 = ["cpu"] * 2, ["cpu"] * 4
PROMPTS = ["### Human: detect all manipulable object parts",
           "the answer is", "provide the joint's type", "Hi my darling"]


def _llama_args(cls, vocab, **kw):
    return cls(**{**dict(dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                         vocab_size=vocab, multiple_of=16, max_seq_len=128,
                         max_batch_size=4), **kw})


# ---------------------------------------------------------------- the mesh


def test_mesh_axes_and_collectives_at_data2_model2(four_ranks):
    facts = [out["facts"] for out in four_ranks["runs"]]
    grid = np.asarray([d.id for d in jcreate_mesh(2, jax.devices()[:4])
                       .devices.flat]).reshape(2, 2)
    for f in facts:
        r = f["rank"]
        assert f["backend"] == "gloo"
        # the model axis over adjacent ranks, as the JAX grid reshape
        assert grid[f["data_index"], f["model_index"]] == r
        assert (f["data_index"], f["model_index"]) == (r // 2, r % 2)
        mates = [q for q in range(4) if q // 2 == r // 2]
        assert f["model_sum"] == sum(q + 1 for q in mates)
        assert f["data_sum"] == sum(q + 1 for q in range(4) if q % 2 == r % 2)
        assert f["model_gather"] == [q + 1.0 for q in mates]
        assert f["object"] == {"from": 0}
        assert f["uneven"] == facts[0]["uneven"]
    assert [row[0] for row in facts[0]["uneven"]] == [0, 1, 1, 2, 3, 3]


@pytest.mark.parametrize("n,mp", [(4, 3), (3, 2)])
def test_create_mesh_refuses_what_does_not_divide(n, mp):
    with pytest.raises(ValueError, match="not divisible"):
        create_mesh(mp, ["cpu"] * n)
    with pytest.raises(ValueError, match="not divisible"):
        jcreate_mesh(mp, jax.devices()[:n])


def test_create_mesh_over_several_devices_needs_ranks():
    with pytest.raises(ValueError, match="init_ranks"):
        create_mesh(2, CPU2)
    one = create_mesh(1, ["cpu"])
    assert (one.dp_size, one.mp_size, one.world_size) == (1, 1, 1)


# ---------------------------------------------------- quantization for TP


def _quant_leaves(tree, path=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _quant_leaves(v, path + (k,))
    elif isinstance(tree, list):
        for i, v in enumerate(tree):
            yield from _quant_leaves(v, path + (i,))
    elif tree is not None:
        yield path, tree


@pytest.mark.parametrize("family", ["llama", "falcon"])
@pytest.mark.parametrize("bits,tp_align,row_parallel", [
    (4, 0, 0), (4, 256, 0), (4, 256, 2), (4, 512, 4), (8, 256, 0),
])
def test_quantize_params_for_tp_matches_jax(family, bits, tp_align,
                                            row_parallel):
    if family == "llama":
        tree = numpy_tree(jllama.init_llama_params,
                          _llama_args(JModelArgs, 256, dim=256), 3)
    else:
        tree = numpy_tree(jfalcon.init_falcon_params, jfalcon.FalconArgs(
            num_layers=2, hidden_size=512, num_attention_heads=8,
            num_kv_heads=2, vocab_size=256, max_seq_len=128), 4)
    want = jquant.quantize_params(tree, bits=bits, tp_align=tp_align,
                                  row_parallel=row_parallel)
    want = params_from_numpy(jax.tree_util.tree_map(np.asarray, want),
                             device="cpu", keep_chunks=True)
    got = tquant.quantize_params(params_from_numpy(tree, device="cpu"),
                                 bits=bits, tp_align=tp_align,
                                 row_parallel=row_parallel)
    got_leaves, want_leaves = dict(_quant_leaves(got)), dict(
        _quant_leaves(want))
    assert got_leaves.keys() == want_leaves.keys()
    chunked = 0
    for path, w in want_leaves.items():
        g = got_leaves[path]
        if isinstance(w, QuantizedWeight):
            assert (g.bits, g.group, g.in_dim, g.k_chunks) == (
                w.bits, w.group, w.in_dim, w.k_chunks), path
            assert torch.equal(g.q, w.q) and torch.equal(g.scale, w.scale)
            chunked += w.k_chunks > 1
        else:
            assert torch.equal(g, w), path
    assert (chunked > 0) == (row_parallel > 1 and bits == 4)


# the decoder widths of the supported models: the 13B, the released 7B's
# InternLM2 (ffn 14336, 8 kv heads) and Falcon-180B
_WIDTHS = {
    "13b": dict(dim=5120, q=5120, kv=5120, ffn=13824, vocab=32000),
    "7b": dict(dim=4096, q=4096, kv=1024, ffn=14336, vocab=92544),
    "falcon180b": dict(dim=14848, q=14848, kv=512, ffn=59392, vocab=65024),
}


@pytest.mark.parametrize("in_dim", sorted({
    v for w in _WIDTHS.values() for v in (w["dim"], w["q"], w["ffn"])
} | {14336, 16384}))
@pytest.mark.parametrize("mp", [2, 4, 8])
def test_int4_chunked_geometry_matches_jax(in_dim, mp):
    assert tquant.int4_chunked_geometry(in_dim, mp) == \
        jquant.int4_chunked_geometry(in_dim, mp)


class _Shape:
    """A stand-in for an array: its shape and rank only."""

    def __init__(self, *shape):
        self.shape = shape
        self.ndim = len(shape)


def _spec_trees(width: dict, mp: int, row_parallel: bool):
    """The JAX tree of a decoder's quantized linears, stacked over 2
    layers, and the port's per-layer one, as shapes, laid out as
    ``quantize_params(tp_align=128 mp, row_parallel=mp or 0)`` packs them;
    and their dense specs."""
    ffn_align = max(128 * mp, 512 * mp) if row_parallel else 128 * mp
    ffn = -(-width["ffn"] // ffn_align) * ffn_align
    vocab = -(-width["vocab"] // (128 * mp)) * (128 * mp)
    dims = {"wq": (width["dim"], width["q"]), "wk": (width["dim"],
                                                     width["kv"]),
            "wv": (width["dim"], width["kv"]), "wo": (width["q"], width["dim"]),
            "w1": (width["dim"], ffn), "w3": (width["dim"], ffn),
            "w2": (ffn, width["dim"])}

    def leaf(pkg, name, K, N, stacked):
        lead = (2,) if stacked else ()
        geo = pkg.int4_chunked_geometry(K, mp) if row_parallel and name in (
            "wo", "w2") else None
        if geo is not None:
            kc = geo[0] // mp
            return pkg.QuantizedWeight(_Shape(*lead, mp, kc // 2, N),
                                       _Shape(*lead, mp, kc // 32, N), 4, 32,
                                       K, mp)
        pad, g = pkg.int4_geometry(K)
        return pkg.QuantizedWeight(_Shape(*lead, pad // 2, N),
                                   _Shape(*lead, pad // g, N), 4, g, K)

    def tree(pkg, stacked):
        group = {"wq", "wk", "wv", "wo"}
        layer = {"attention": {n: {"weight": leaf(pkg, n, *dims[n], stacked)}
                               for n in dims if n in group},
                 "feed_forward": {n: {"weight": leaf(pkg, n, *dims[n],
                                                     stacked)}
                                  for n in dims if n not in group}}
        head = {"weight": leaf(pkg, "output", width["dim"], vocab, False)}
        if stacked:
            return {"layers": layer, "output": head}
        return {"layers": [layer, layer], "output": head}

    jdense = jllama.llama_partition_specs(JModelArgs())
    tdense = tllama.llama_partition_specs(ModelArgs(n_layers=2))
    for d in (jdense, tdense):
        del d["tok_embeddings"], d["norm"]
    jdense["layers"] = {k: jdense["layers"][k]
                        for k in ("attention", "feed_forward")}
    tdense["layers"] = [{k: lp[k] for k in ("attention", "feed_forward")}
                        for lp in tdense["layers"]]
    return tree(jquant, True), tree(tquant, False), jdense, tdense


@pytest.mark.parametrize("model", sorted(_WIDTHS))
@pytest.mark.parametrize("mp", [2, 4, 8])
@pytest.mark.parametrize("row_parallel", [False, True],
                         ids=["all_column", "row_parallel"])
def test_quantized_partition_specs_match_jax(model, mp, row_parallel):
    jtree, ttree, jdense, tdense = _spec_trees(_WIDTHS[model], mp,
                                               row_parallel)
    want = jquant.quantized_partition_specs(jdense, jtree, mp)
    got = tquant.quantized_partition_specs(tdense, ttree, mp)

    def specs(qw, stacked):
        drop = 1 if stacked else 0
        return (tuple(qw.q)[drop:], tuple(qw.scale)[drop:], qw.k_chunks)

    for group, names in (("attention", ("wq", "wk", "wv", "wo")),
                         ("feed_forward", ("w1", "w2", "w3"))):
        for n in names:
            w = specs(want["layers"][group][n]["weight"], True)
            for lp in got["layers"]:
                assert specs(lp[group][n]["weight"], False) == w, (group, n)
    assert specs(got["output"]["weight"], False) == specs(
        want["output"]["weight"], False)


def test_bridge_carries_chunk_packed_leaves_as_chunks():
    tree = numpy_tree(jllama.init_llama_params,
                      _llama_args(JModelArgs, 256, dim=256), 5)
    jq = jax.tree_util.tree_map(np.asarray, jquant.quantize_params(
        tree, tp_align=256, row_parallel=2))
    kept = params_from_numpy(jq, device="cpu", keep_chunks=True)
    one = params_from_numpy(jq, device="cpu")
    w2k = kept["layers"][1]["feed_forward"]["w2"]["weight"]
    w2o = one["layers"][1]["feed_forward"]["w2"]["weight"]
    assert (w2k.k_chunks, tuple(w2k.q.shape)) == (2, (2, 256, 256))
    assert (w2o.k_chunks, tuple(w2o.q.shape)) == (1, (512, 256))
    want = np.asarray(jquant._dequantize_leaf(
        jax.tree_util.tree_map(lambda x: jnp.asarray(x[1]),
                               jq["layers"]["feed_forward"]["w2"]["weight"]),
        jnp.float32))
    for w in (w2k, w2o):
        np.testing.assert_array_equal(
            tquant._dequantize_leaf(w, torch.float32).numpy(), want)


# ------------------------------------------------------- sharded layers


def _linear_cases():
    rng = np.random.default_rng(7)

    def dense(K, N):
        return torch.from_numpy((rng.standard_normal((K, N)) / K ** 0.5)
                                .astype(np.float32))

    chunked = tquant._quantize_leaf_int4(dense(1024, 256), k_chunks=2)
    weights = {
        "dense_col": (dense(256, 512), "column"),
        "dense_row": (dense(512, 256), "row"),
        "int4_col": (tquant._quantize_leaf_int4(dense(256, 512)), "column"),
        "int4_all_column_row": (tquant._quantize_leaf_int4(dense(256, 256)),
                                "row"),
        "int4_chunk_row": (chunked, "row"),
        "int8_col": (tquant._quantize_leaf_int8(dense(256, 512)), "column"),
        "int4_replicated": (tquant._quantize_leaf_int4(dense(256, 192)),
                            "column"),
    }
    col, row = P(None, "model"), P("model", None)
    specs = {
        "dense_col": col, "dense_row": row,
        "int4_col": QuantizedWeight(col, col, 4),
        "int4_all_column_row": QuantizedWeight(col, col, 4),
        "int4_chunk_row": QuantizedWeight(P("model", None, None),
                                          P("model", None, None), 4),
        "int8_col": QuantizedWeight(col, col, 8),
        "int4_replicated": QuantizedWeight(P(None, None), P(None, None), 4),
    }
    return weights, specs


def _in_dim(w) -> int:
    if isinstance(w, QuantizedWeight):
        return w.in_dim if w.bits == 4 else w.q.shape[-2]
    return w.shape[0]


def test_sharded_linears_match_the_unsharded_product():
    from a3vlm_tpu_torch.ops.quant_matmul import qmat

    weights, specs = _linear_cases()
    rng = np.random.default_rng(8)
    xs = {n: torch.from_numpy(rng.standard_normal((3, _in_dim(w))).astype(
        np.float32)) for n, (w, _) in weights.items()}
    out = run_spmd(ranks.sharded_linears, CPU2, weights, specs, xs,
                   model_parallel_size=2)
    for name, (w, kind) in weights.items():
        full = qmat(xs[name], w, "plain")
        if kind == "column":
            got = torch.cat([o[name] for o in out], dim=-1)
        else:
            got = out[0][name]
            assert torch.equal(out[1][name], got), name
        np.testing.assert_allclose(got.numpy(), full.numpy(), atol=1e-5,
                                   rtol=0, err_msg=name)


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16_layout", "int8"])
@pytest.mark.parametrize("span", [1, 3], ids=["decode", "verify"])
def test_sharded_decode_and_verify_attention(kv8, span):
    """The attention of a rank's kv heads (its q heads, its cache panels)
    is the unsharded attention's heads: no collective is involved."""
    rng = np.random.default_rng(9)
    B, H, Hkv, S, D = 2, 8, 4, 32, 16

    def t(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))

    q, k, v = t(B, span, H, D), t(B, span, Hkv, D), t(B, span, Hkv, D)
    base_k, base_v = t(B, Hkv, S, D), t(B, Hkv, S, D)
    pos = torch.tensor([5, 11], dtype=torch.int32)
    valid = pos + span

    def run(h0, h1):
        g = H // Hkv
        kv = slice(h0, h1)
        if kv8:
            ck = make_quantized_kv(B, h1 - h0, S, D, device="cpu")
            cv = make_quantized_kv(B, h1 - h0, S, D, device="cpu")
            from a3vlm_tpu_torch.ops.decode_attention import update_decode_cache
            update_decode_cache(ck, cv, base_k[:, kv].transpose(1, 2),
                                base_v[:, kv].transpose(1, 2), 0)
        else:
            ck, cv = base_k[:, kv].clone(), base_v[:, kv].clone()
        return update_and_attend_decode_cache(
            q[:, :, h0 * g:h1 * g], ck, cv, k[:, :, kv], v[:, :, kv], pos,
            valid, mask="causal" if span > 1 else None, impl="plain")

    full = run(0, Hkv)
    for mp in (2, 4):
        n = Hkv // mp
        parts = [run(r * n, (r + 1) * n) for r in range(mp)]
        torch.testing.assert_close(torch.cat(parts, dim=2), full, atol=1e-6,
                                   rtol=0)


def test_crop_sharded_encode_image_matches_unsharded():
    cfg = tiny_ens5_config(128)
    tree = numpy_tree(jens5.init_ens5_params, jens5.tiny_ens5_config(128), 6)
    params = params_from_numpy(tree, device="cpu")
    image = torch.from_numpy(np.random.default_rng(10).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    want = tens5.encode_image_features(params, cfg, image)
    out = run_spmd(ranks.encode_crops, ["cpu"] * 3, params, cfg, image,
                   model_parallel_size=1)
    for o in out:  # 10 crops over 3 ranks: 4, 3, 3
        for key in ("q", "ens"):
            assert torch.equal(o[key], out[0][key])
            torch.testing.assert_close(o[key], want[key], atol=1e-5, rtol=0)


# ------------------------------------------- Generator(mesh=) on 4 ranks
# (against JAX: tests/test_torch_parallel_generate.py)

# a batch of 4; one request through the lookup loop (falcon's ops take
# the vanilla loop there, as in the JAX Generator)
CALLS = [(PROMPTS, dict(max_gen_len=10, temperature=0.0)),
         (PROMPTS[:1], dict(max_gen_len=10, temperature=0.0, draft_k=3))]


@pytest.fixture(scope="module")
def tok(tiny_tokenizer_dir):
    return Tokenizer(tiny_tokenizer_dir)


@pytest.fixture(scope="module")
def four_ranks(tok, tiny_tokenizer):
    """One spawn of four ranks for the module: ``Generator(mesh=)`` at mp 4,
    then over a data 2 x model 2 mesh of the same ranks (its coordinates
    and collectives too); and the same generation on one rank."""
    vocab = -(-tiny_tokenizer.n_words // 512) * 512
    targs = _llama_args(ModelArgs, vocab)
    tspec = tllama.llama_partition_specs(targs)
    tparams = params_from_numpy(numpy_tree(
        jllama.init_llama_params, _llama_args(JModelArgs, vocab), 14),
        device="cpu")
    one = ranks.generate_sharded(create_mesh(1, ["cpu"]), tparams, targs,
                                 tspec, tok, CALLS)
    runs = run_spmd(ranks.four_rank_suite, CPU4, tparams, targs, tspec, tok,
                    CALLS, model_parallel_size=4)
    return {"one": one, "runs": runs}


@pytest.mark.parametrize("layout", ["mp4", "data2_model2"])
def test_generator_on_four_ranks_matches_mp1(four_ranks, layout):
    """mp 4 (a kv head a rank) and data 2 x model 2 (the batch of 4 split
    over "data") give the one-rank strings and prefill logits."""
    one = four_ranks["one"]
    out = [run[layout] for run in four_ranks["runs"]]
    for texts, logits in out:
        assert texts == one[0]
        assert torch.equal(logits, out[0][1])
        torch.testing.assert_close(logits, one[1], atol=ATOL, rtol=0)
