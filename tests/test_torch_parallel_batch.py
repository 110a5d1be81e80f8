"""``ContinuousBatcher(mesh=)`` of the port against the JAX batcher with
``mesh=`` (model 2 over its 8 CPU devices), on the CPU: the port's ranks
are gloo processes, every rank constructing and stepping the batcher. At
mp 2 (the pool's kv heads split) in the vanilla, speculative, grammar and
int8-cache modes, and at data 2 x model 2 (the pool's slots split over
"data", each rank writing its own slots). The eval CLI's
``--model_parallel_size``: tests/test_torch_parallel_cli.py.

Tolerances: float32; the strings, every ``decode`` call (ids and
schedule) and the step counts identical, on every rank."""

import jax
import jax.numpy as jnp
import pytest
import torch
import torch_parallel_ranks as ranks
from test_torch_families import numpy_tree
from test_torch_serving_batch import GENS, PROMPTS, _args, _Recording

from a3vlm_tpu import constrained as jconstrained
from a3vlm_tpu.config import ModelArgs as JModelArgs
from a3vlm_tpu.models import llama as jllama
from a3vlm_tpu.parallel import create_mesh as jcreate_mesh
from a3vlm_tpu.parallel import shard_params as jshard_params
from a3vlm_tpu.serving_batch import ContinuousBatcher as JBatcher
from a3vlm_tpu_torch import constrained as tconstrained
from a3vlm_tpu_torch.checkpoint.bridge import params_from_numpy
from a3vlm_tpu_torch.config import ModelArgs
from a3vlm_tpu_torch.models import llama as tllama
from a3vlm_tpu_torch.parallel.launch import run_spmd
from a3vlm_tpu_torch.tokenizer import Tokenizer

torch.set_num_threads(1)
MODES = {
    "vanilla": {},
    "draft3": {"draft_k": 3},
    "grammar": {"fsm": True},
    "kv8": {"kv_cache_bits": 8},
}


@pytest.fixture(scope="module")
def weights(tiny_tokenizer, tiny_tokenizer_dir):
    vocab = -(-tiny_tokenizer.n_words // 128) * 128
    tree = numpy_tree(jllama.init_llama_params,
                      _args(vocab, 192, JModelArgs), 17)
    return {"vocab": vocab, "tree": tree,
            "tparams": params_from_numpy(tree, device="cpu"),
            "ttok": Tokenizer(tiny_tokenizer_dir)}


_JAX_RUNS: dict = {}


def _jax_run(weights, tiny_tokenizer, mode, opts, gens, grammar):
    """The JAX batcher's strings, steps and decode calls in ``mode`` (one
    run a mode for the module)."""
    if mode in _JAX_RUNS:
        return _JAX_RUNS[mode]
    vocab = weights["vocab"]
    jmesh = jcreate_mesh(2)
    jspecs = jllama.llama_partition_specs(_args(vocab, 192, JModelArgs))
    jparams = jshard_params(jax.tree_util.tree_map(jnp.asarray,
                                                   weights["tree"]),
                            jmesh, jspecs)
    jtok = _Recording(tiny_tokenizer)
    jfsm = None
    if grammar:
        jfsm = jconstrained.fsm_for_task("joint_rec", tiny_tokenizer)
    jb = JBatcher(jparams, _args(vocab, 192, JModelArgs), jtok, mesh=jmesh,
                  vocab_limit=tiny_tokenizer.n_words, fsm=jfsm, **opts)
    want = jb.generate(PROMPTS, max_gen_len=gens, temperature=0.0)
    _JAX_RUNS[mode] = (want, jb.steps, jtok.decoded)
    return _JAX_RUNS[mode]


# the runs of each layout, one spawn a layout: (devices, mp, modes)
LAYOUTS = {"model2": (["cpu"] * 2, 2, list(MODES)),
           "data2_model2": (["cpu"] * 4, 2, ["vanilla", "draft3"])}


def _mode_opts(mode):
    opts = dict(MODES[mode], slots=4)
    grammar = opts.pop("fsm", False)
    return opts, grammar, [24, 16, 30, 20, 12] if grammar else GENS


@pytest.fixture(scope="module")
def port_runs(weights):
    targs = _args(weights["vocab"], 192, ModelArgs)
    out = {}
    for name, (devices, mp, modes) in LAYOUTS.items():
        runs = []
        for mode in modes:
            opts, grammar, gens = _mode_opts(mode)
            tfsm = tconstrained.fsm_for_task(
                "joint_rec", weights["ttok"]) if grammar else None
            runs.append((PROMPTS, gens, dict(opts, fsm=tfsm)))
        res = run_spmd(ranks.batcher_modes, devices, weights["tparams"],
                       targs, weights["ttok"],
                       tllama.llama_partition_specs(targs), runs,
                       model_parallel_size=mp)
        for i, mode in enumerate(modes):
            out[(name, mode)] = [r[i] for r in res]
    return out


@pytest.mark.parametrize("layout,mode", [
    (name, mode) for name, (_, _, modes) in LAYOUTS.items()
    for mode in modes], ids=lambda v: v)
def test_batcher_mesh_matches_jax(weights, tiny_tokenizer, port_runs,
                                  layout, mode):
    devices, mp, _ = LAYOUTS[layout]
    opts, grammar, gens = _mode_opts(mode)
    want, jsteps, jdecoded = _jax_run(weights, tiny_tokenizer, mode, opts,
                                      gens, grammar)
    dp = len(devices) // mp
    for rank, (got, steps, decoded, slot0, panel) in enumerate(
            port_runs[(layout, mode)]):
        assert got == want
        assert steps == jsteps and decoded == jdecoded
        # this rank's slots and kv heads of the pool
        assert slot0 == (rank // mp) * (4 // dp)
        assert tuple(panel)[:2] == (4 // dp, 2 // mp)
