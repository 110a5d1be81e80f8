"""What each rank runs in the port's tests on several ranks
(``tests/test_torch_parallel*.py``): functions of ``(mesh, *args)`` for
``parallel.launch.run_spmd``, and of ``(model, ...)`` for
``ModelServer.map_ranks``. The ranks are new processes: this module
imports torch and the port only, no JAX."""

import torch

from a3vlm_tpu_torch.parallel import mesh as pmesh
from a3vlm_tpu_torch.parallel import tp


def mesh_facts(mesh):
    """This rank's coordinates and the collectives over each axis."""
    x = torch.tensor([float(mesh.rank + 1)])
    return {
        "rank": mesh.rank, "backend": mesh.backend,
        "model_index": mesh.model_index, "data_index": mesh.data_index,
        "model_sum": float(pmesh.all_reduce(x, mesh, "model")),
        "data_sum": float(pmesh.all_reduce(x, mesh, "data")),
        "model_gather": pmesh.all_gather(x, mesh, 0, "model").tolist(),
        "data_gather": pmesh.all_gather(x, mesh, 0, "data").tolist(),
        "object": pmesh.broadcast_object({"from": mesh.rank}, mesh),
        "uneven": pmesh.all_gather_uneven(
            torch.full((mesh.rank % 2 + 1, 2), float(mesh.rank)), mesh,
            [r % 2 + 1 for r in range(mesh.world_size)]).tolist(),
    }


def sharded_linears(mesh, weights, specs, xs):
    """Each of ``weights`` ({name: (full weight, "column" or "row")})
    split by its spec: ``tp.column`` of ``xs[name]``, or ``tp.row`` of this
    rank's share of its columns."""
    out = {}
    with pmesh.use_mesh(mesh):
        for name, (w, kind) in weights.items():
            local = pmesh.shard_params({"w": w}, mesh,
                                       {"w": specs[name]})["w"]
            x = xs[name]
            if kind == "column":
                out[name] = tp.column(x, local, "auto")
            else:
                out[name] = tp.row(tp._share(x, mesh), local, "auto")
    return out


def encode_crops(mesh, params, cfg, image):
    """The ens5 tower features of ``image`` with the crops split over the
    mesh."""
    from a3vlm_tpu_torch.models import ens5

    with pmesh.use_mesh(mesh):
        return ens5.encode_image_features(params, cfg, image)


def generate_sharded(mesh, params, args, specs, tok, calls,
                     ops_name="llama"):
    """Each ``(prompts, kwargs)`` of ``calls`` through
    ``Generator.generate`` on this rank's shard, and the prefill logits of
    the first call's prompts' common head."""
    from a3vlm_tpu_torch.generation import FALCON_GEN_OPS, LLAMA_GEN_OPS
    from a3vlm_tpu_torch.generation import Generator
    from a3vlm_tpu_torch.models import falcon, llama

    local = pmesh.shard_params(params, mesh, specs)
    ops = FALCON_GEN_OPS if ops_name == "falcon" else LLAMA_GEN_OPS
    gen = Generator(local, args, tok, vocab_limit=tok.n_words, mesh=mesh,
                    ops=ops)
    texts = [gen.generate(prompts, **kw) for prompts, kw in calls]
    ids = [tok.encode(p, bos=True, eos=False) for p in calls[0][0]]
    n = min(len(t) for t in ids)
    tokens = torch.tensor([t[:n] for t in ids])
    with pmesh.use_mesh(mesh), torch.inference_mode():
        mod = falcon if ops_name == "falcon" else llama
        cache = ops.create_cache(args, len(ids), n, torch.float32, "cpu")
        logits = mod.prefill(local, args, cache, tokens)[0]
    return texts, logits


def batcher_sharded(mesh, params, args, tok, specs, prompts, gens, kw):
    """A ``ContinuousBatcher(mesh=)`` over this rank's shard: its strings,
    step count and every ``decode`` call."""
    from a3vlm_tpu_torch.serving_batch import ContinuousBatcher

    class Recording:
        def __init__(self, t):
            self._t, self.decoded = t, []

        def decode(self, ids):
            self.decoded.append(list(ids))
            return self._t.decode(ids)

        def __getattr__(self, name):
            return getattr(self._t, name)

    rec = Recording(tok)
    local = pmesh.shard_params(params, mesh, specs)
    cb = ContinuousBatcher(local, args, rec, mesh=mesh, device="cpu",
                           vocab_limit=tok.n_words, **kw)
    out = cb.generate(prompts, max_gen_len=gens, temperature=0.0)
    panel = cb.cache.k[0]
    return (out, cb.steps, rec.decoded, cb._slot0,
            tuple(getattr(panel, "qv", panel).shape))


def rank_state(model):
    """A ``ModelServer`` rank's view: rank, backend and the output columns
    of its first layer's wq."""
    wq = tp.local_weight(model.decoder["layers"][0]["attention"]["wq"][
        "weight"])
    n = (wq.q if hasattr(wq, "q") else wq).shape[-1]
    return {"rank": model.mesh.rank, "backend": model.mesh.backend,
            "wq_columns": n}


def generate_ids(model, prompts, **kw):
    """``MetaModel.generate_tokens`` on this rank (every rank calls it)."""
    return model.generate_tokens(prompts, **kw)


def generate_many(mesh, cases):
    """``generate_sharded`` over each of ``cases`` (its arguments after
    the mesh), one spawn for them all."""
    return [generate_sharded(mesh, *case) for case in cases]


def four_rank_suite(mesh, params, args, specs, tok, calls):
    """On four ranks: ``generate_sharded`` at mp 4 (``mesh``), then a
    data 2 x model 2 mesh over the same ranks, its ``mesh_facts`` and its
    ``generate_sharded``."""
    from a3vlm_tpu_torch.parallel.mesh import create_mesh

    mp4 = generate_sharded(mesh, params, args, specs, tok, calls)
    grid = create_mesh(2, mesh.devices)
    return {"mp4": mp4, "facts": mesh_facts(grid),
            "data2_model2": generate_sharded(grid, params, args, specs, tok,
                                             calls)}


def batcher_modes(mesh, params, args, tok, specs, runs):
    """``batcher_sharded`` for each ``(prompts, gens, kwargs)`` of
    ``runs``, one spawn for them all."""
    return [batcher_sharded(mesh, params, args, tok, specs, *run)
            for run in runs]
