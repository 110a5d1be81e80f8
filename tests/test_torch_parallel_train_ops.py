"""The tensor-parallel products' gradients and the step at data 1 x model
2 on two gloo ranks (one spawn for the module,
``tests/torch_parallel_train_ranks.py``), on the CPU in float32:

- each ``parallel.tp`` product on its shard against the same product
  unsharded in one process (``qmat``): output, the input's gradient (a
  row product's: this rank's share of it) and the trainable blocks'
  gradients; dense column and row shards, the all-column int4 form
  (a column shard in ``tp.row``), the chunk-packed int4 row, the padded-K
  row, a replicated int4 row, ``head``, ``embed``, and ``LoraWeight`` over
  column and row shards and over the all-column int4 form;
- the QLoRA step at data 1 x model 2 against the JAX step on a 1 x 2 mesh
  of host devices (tests/test_torch_parallel_train.py's setup);
- a decoder's training forward runs no more collectives than under
  ``torch.no_grad``, and the same ones (the new collectives act in the
  backward only);
- internlm_ems5_light's image prefill and greedy decode at model 2 give
  the ids of one rank (the JAX package's multichip decode leg,
  __graft_entry__.py:428-470).

Tolerances: products and gradients to 1e-5 absolute (float32; a
gradient summed over ranks differs from one process's in order only);
the step as in tests/test_torch_parallel_train.py; ids exact."""

import copy

import numpy as np
import pytest
import torch
import torch_parallel_train_ranks as ranks
from test_torch_families import numpy_tree
from test_torch_parallel_train import (
    _hold_steps,
    family_setup,
    jax_mesh_steps,
    make_batches,
    torch_batches,
)

from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.meta import MetaModel
from a3vlm_tpu_torch.models import internlm_ems5_light as til
from a3vlm_tpu_torch.models import llama as tllama
from a3vlm_tpu_torch.ops.quant_matmul import qmat
from a3vlm_tpu_torch.parallel import P
from a3vlm_tpu_torch.parallel.launch import run_spmd
from a3vlm_tpu_torch.quant import (
    LoraWeight,
    _quantize_leaf_int4,
    quantized_partition_specs,
    tree_map,
)

torch.set_num_threads(1)
ATOL = 1e-5
CPU2 = ["cpu"] * 2
COL, ROW = P(None, "model"), P("model", None)


def _quantized(w, spec, k_chunks=1):
    qw = _quantize_leaf_int4(w, k_chunks=k_chunks)
    return qw, quantized_partition_specs({"w": spec}, {"w": qw}, 2)["w"]


def product_cases() -> dict:
    """name -> the product, its full weight and spec, adapters, the input
    and the output's cotangent."""
    g = torch.Generator().manual_seed(11)

    def rnd(*shape, scale=0.1):
        return torch.randn(*shape, generator=g) * scale

    def case(kind, w, spec, K, N, lora=False, x=None):
        out = {"kind": kind, "w": w, "spec": spec,
               "x": rnd(2, 3, K, scale=1.0) if x is None else x,
               "g": rnd(2, 3, N, scale=1.0)}
        if lora:
            out.update(a=rnd(K, 4), b=rnd(4, N))
        return out

    D, N, F = 128, 256, 512
    q_col, s_col = _quantized(rnd(D, N), COL)      # columns split
    q_ac, s_ac = _quantized(rnd(F, N), ROW)        # all-column w2
    q_ch, s_ch = _quantized(rnd(1024, N), ROW, 2)  # a chunk a rank
    q_pad, s_pad = _quantized(rnd(1000, 64), ROW, 2)  # K padded to 1024
    q_rep, s_rep = _quantized(rnd(F, 64), ROW)     # N too narrow: whole
    tokens = torch.randint(0, 96, (2, 5), generator=g)
    return {
        "column_dense": case("column", rnd(D, N), COL, D, N),
        "row_dense": case("row", rnd(F, N), ROW, F, N),
        "column_int4": case("column", q_col, s_col, D, N),
        "row_int4_all_column": case("row", q_ac, s_ac, F, N),
        "row_int4_chunks": case("row", q_ch, s_ch, 1024, N),
        "row_int4_padded_k": case("row", q_pad, s_pad, 1000, 64),
        "row_int4_replicated": case("row", q_rep, s_rep, F, 64),
        "head": case("head", rnd(D, N), COL, D, N),
        "embed": {"kind": "embed", "w": rnd(96, D), "spec": COL,
                  "x": tokens, "g": rnd(2, 5, D, scale=1.0)},
        "lora_column_dense": case("column", rnd(D, N), COL, D, N, lora=True),
        "lora_row_dense": case("row", rnd(F, N), ROW, F, N, lora=True),
        "lora_column_int4": case("column", q_col, s_col, D, N, lora=True),
        "lora_row_int4_all_column": case("row", q_ac, s_ac, F, N,
                                         lora=True),
    }


CASES = product_cases()


def unsharded(case):
    """The product in one process: output and gradients."""
    leaves = {}
    if case["kind"] == "embed":
        leaves["w"] = case["w"].clone().requires_grad_(True)
        y = leaves["w"][case["x"]]
        x = None
    else:
        x = case["x"].clone().requires_grad_(True)
        w = case["w"]
        if "a" in case:
            leaves = {k: case[k].clone().requires_grad_(True)
                      for k in ("a", "b")}
            w = LoraWeight(w, leaves["a"], leaves["b"])
        y = qmat(x, w)
    (y * case["g"]).sum().backward()
    out = {"y": y.detach(), "dx": None if x is None else x.grad}
    out.update({f"d{k}": t.grad for k, t in leaves.items()})
    return out


def _block(t, dim, index, parts=2):
    n = t.shape[dim] // parts
    return t.narrow(dim, index * n, n)


@pytest.fixture(scope="module")
def internlm_model():
    cfg = til.tiny_config(vocab_size=128)
    return MetaModel("internlm_ems5_light", with_visual=True,
                     max_seq_len=512, vocab_size=100, model_cfg=cfg, seed=5,
                     device="cpu")


def _internlm_inputs(model):
    g = torch.Generator().manual_seed(3)
    size = model.cfg.image_size
    images = torch.randn(2, size, size, 3, generator=g)
    prompts = [[1, 5, 9, 33, 7], [1, 44, 12, 3, 70]]
    specs = {k: tree_map(lambda _: P(), v) for k, v in model.params.items()
             if k != "llama"}
    specs["llama"] = tllama.llama_partition_specs(model.cfg.llama)
    return specs, prompts, images


def _decoder():
    args = ModelArgs(dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                     vocab_size=256, multiple_of=16, max_seq_len=64)
    jargs = JModelArgs(dim=128, n_layers=2, n_heads=4, n_kv_heads=4,
                       vocab_size=256, multiple_of=16, max_seq_len=64)
    params = params_from_numpy(numpy_tree(jllama.init_llama_params, jargs,
                                          8), device="cpu")
    tokens = torch.randint(0, 256, (2, 12),
                           generator=torch.Generator().manual_seed(4))
    return params, args, tokens


@pytest.fixture(scope="module")
def qlora():
    return family_setup("llama_ens5", 31)


@pytest.fixture(scope="module")
def two_ranks(qlora, internlm_model):
    specs, prompts, images = _internlm_inputs(internlm_model)
    return run_spmd(
        ranks.two_rank_train_suite, CPU2, CASES,
        (copy.deepcopy(qlora["model"]), copy.deepcopy(qlora["lora"]),
         torch_batches(make_batches(2, 2, 2, seed=60)), 2, 1e-3, 0.1),
        _decoder(),
        (internlm_model, specs, prompts, images, 4),
        model_parallel_size=2)


@pytest.mark.parametrize("name", list(CASES))
def test_product_gradients_match_one_process(name, two_ranks):
    case = CASES[name]
    want = unsharded(case)
    kind = case["kind"]
    for rank, run in enumerate(two_ranks):
        got = run["products"][name]
        torch.testing.assert_close(got["y"], want["y"], atol=ATOL, rtol=0)
        if kind == "row":  # this rank's share of the input's columns
            torch.testing.assert_close(got["dx"], _block(want["dx"], -1,
                                                         rank),
                                       atol=ATOL, rtol=0)
        elif kind != "embed":
            torch.testing.assert_close(got["dx"], want["dx"], atol=ATOL,
                                       rtol=0)
        if kind == "embed":  # the table's columns
            torch.testing.assert_close(got["dw"], _block(want["dw"], -1,
                                                         rank),
                                       atol=ATOL, rtol=0)
        if "a" in case:
            if kind == "column":  # a replicated, b split on its output
                da, db = want["da"], _block(want["db"], -1, rank)
                assert torch.equal(got["da"], two_ranks[0]["products"][
                    name]["da"])
            else:  # a split on its input, b replicated
                da, db = _block(want["da"], 0, rank), want["db"]
                assert torch.equal(got["db"], two_ranks[0]["products"][
                    name]["db"])
            torch.testing.assert_close(got["da"], da, atol=ATOL, rtol=0)
            torch.testing.assert_close(got["db"], db, atol=ATOL, rtol=0)


def test_qlora_step_at_data1_model2_matches_jax_mesh(qlora, two_ranks):
    """Two QLoRA steps (accumulation 2, remat, the clip active) at data 1 x
    model 2: as the JAX step on a 1 x 2 mesh."""
    want = jax_mesh_steps(qlora, make_batches(2, 2, 2, seed=60), 2, 2, 2,
                          remat=True)
    _hold_steps([r["qlora"] for r in two_ranks], *want)


def test_training_forward_adds_no_collective(two_ranks):
    """The decoder's forward recording a gradient runs the collectives of
    its forward under ``torch.no_grad`` (two all-reduces a layer, the
    embedding's and the head's gathers) and gives the same logits; its
    backward adds one all-reduce per shared column input (q / k / v,
    gate / up, the head's) and no gather."""
    params, args, tokens = _decoder()
    with torch.no_grad():
        want = tllama.forward_train(params, args, tokens)
    for run in two_ranks:
        dec = run["decoder"]
        assert dec["no_grad"] == dec["grad"] == {
            "all_reduce": 2 * args.n_layers, "all_gather_into_tensor": 2}
        assert dec["backward"] == {"all_reduce": 2 * args.n_layers + 1}
        frozen, recording = dec["logits"]
        assert torch.equal(frozen, recording)
        torch.testing.assert_close(recording, want, atol=1e-4, rtol=0)
    assert torch.equal(two_ranks[0]["decoder"]["norm_grad"],
                       two_ranks[1]["decoder"]["norm_grad"])


def test_internlm_prefill_and_decode_at_model2(internlm_model, two_ranks):
    """internlm_ems5_light (grouped-query decoder over DINOv2 and
    ConvNeXt) at model 2: every rank's ids are one rank's."""
    _, prompts, images = _internlm_inputs(internlm_model)
    want = internlm_model.generate_tokens(prompts, images=images,
                                          max_gen_len=4, temperature=0.0)
    assert all(len(ids) == 4 for ids in want)
    for run in two_ranks:
        assert run["internlm"] == want


def test_step_grad_norm_counts_each_element_once():
    """``global_norm`` on a mesh: a split leaf's squares summed over
    "model", a replicated leaf's counted once (a mesh of one rank: the
    plain norm)."""
    from a3vlm_tpu_torch.train.step import global_norm

    leaves = [torch.tensor([3.0]), torch.tensor([4.0])]
    assert float(global_norm(leaves)) == 5.0
    assert float(global_norm(leaves, [True, False], None)) == 5.0
    assert np.isclose(float(global_norm([torch.ones(4)])), 2.0)
