"""``Generator(mesh=)`` of the port on gloo ranks against the JAX
``Generator(mesh=)`` (model axis 2 over its 8 CPU devices) and the port on
one rank, on tiny decoders in float32: LLaMA in the all-column int4 form
(``tp_align``) and the row-parallel one (``row_parallel``: chunk-packed wo
/ w2), Falcon dense (``falcon_partition_specs``) and row-parallel.
(LLaMA at mp 4 and at data 2 x model 2: tests/test_torch_parallel.py.)

Tolerances: greedy strings identical (a batch of 4, and one request
through the lookup loop), every rank's identical to rank 0's; prefill
logits to 1e-4 (float32; a row-parallel product sums its partials over
ranks in another order) and bitwise equal on every rank."""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_families import numpy_tree
from test_torch_parallel import (  # noqa: F401 (tok: a fixture)
    ATOL,
    CALLS,
    CPU2,
    _llama_args,
    tok,
)

from a3vlm_tpu import quant as jquant
from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.generation import FALCON_GEN_OPS as JFALCON_OPS
from a3vlm_tpu.generation import Generator as JGenerator
from a3vlm_tpu.models import falcon as jfalcon
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.parallel import create_mesh as jcreate_mesh
from a3vlm_tpu.parallel import shard_params as jshard_params
from a3vlm_tpu_torch import quant as tquant
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.models import falcon as tfalcon
from a3vlm_tpu_torch.models import llama as tllama
from a3vlm_tpu_torch.parallel import create_mesh
from a3vlm_tpu_torch.parallel.launch import run_spmd

torch.set_num_threads(1)
def _decoder(family, vocab, quant):
    """(JAX args, port args, JAX specs, port specs, JAX params, port
    params) of a tiny decoder, quantized as ``quant`` says: None,
    "all_column" (tp_align) or "row_parallel" (and row_parallel 2)."""
    if family == "falcon":
        fields = dict(num_layers=2, hidden_size=128, num_attention_heads=4,
                      num_kv_heads=2, max_seq_len=128)
        jargs = jfalcon.FalconArgs(vocab_size=vocab, **fields)
        targs = tfalcon.FalconArgs(vocab_size=vocab, **fields)
        tree = numpy_tree(jfalcon.init_falcon_params, jargs, 12)
        jspec, tspec = (jfalcon.falcon_partition_specs(jargs),
                        tfalcon.falcon_partition_specs(targs))
    else:
        jargs = _llama_args(JModelArgs, vocab, n_kv_heads=2)
        targs = _llama_args(ModelArgs, vocab, n_kv_heads=2)
        tree = numpy_tree(jllama.init_llama_params, jargs, 11)
        jspec, tspec = (jllama.llama_partition_specs(jargs),
                        tllama.llama_partition_specs(targs))
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    tparams = params_from_numpy(tree, device="cpu")
    if quant:
        kw = dict(tp_align=256, row_parallel=2 if quant == "row_parallel"
                  else 0)
        jparams = jquant.quantize_params(jparams, **kw)
        tparams = tquant.quantize_params(tparams, **kw)
        jspec = jquant.quantized_partition_specs(jspec, jparams, 2)
        tspec = tquant.quantized_partition_specs(tspec, tparams, 2)
    return jargs, targs, jspec, tspec, jparams, tparams


CASES = [("llama", "all_column"), ("llama", "row_parallel"),
         ("falcon", None), ("falcon", "row_parallel")]


@pytest.fixture(scope="module")
def decoders(tok, tiny_tokenizer):
    """Each case's decoder in both packages, the port's run on one rank,
    and every case on 2 ranks in one spawn."""
    vocab = -(-tiny_tokenizer.n_words // 256) * 256
    built = {case: _decoder(case[0], vocab, case[1]) for case in CASES}
    one = {case: ranks.generate_sharded(
        create_mesh(1, ["cpu"]), b[5], b[1], b[3], tok, CALLS[:1], case[0])
        for case, b in built.items()}
    runs = run_spmd(ranks.generate_many, CPU2,
                    [(b[5], b[1], b[3], tok, CALLS, case[0])
                     for case, b in built.items()], model_parallel_size=2)
    return built, one, {case: [r[i] for r in runs]
                        for i, case in enumerate(CASES)}


@pytest.mark.parametrize("family,quant", CASES)
def test_generator_mesh_matches_jax_and_mp1(family, quant, decoders,
                                            tiny_tokenizer):
    built, ones, runs = decoders
    jargs, _, jspec, _, jparams, _ = built[(family, quant)]
    jmesh = jcreate_mesh(2)
    jgen = JGenerator(jshard_params(jparams, jmesh, jspec), jargs,
                      tiny_tokenizer, vocab_limit=tiny_tokenizer.n_words,
                      mesh=jmesh,
                      **({"ops": JFALCON_OPS} if family == "falcon" else {}))
    want = [jgen.generate(prompts, **kw) for prompts, kw in CALLS]
    one = ones[(family, quant)]
    out = runs[(family, quant)]
    assert one[0] == want[:1]
    for texts, logits in out:
        assert texts == want
        assert torch.equal(logits, out[0][1])
        torch.testing.assert_close(logits, one[1], atol=ATOL, rtol=0)
