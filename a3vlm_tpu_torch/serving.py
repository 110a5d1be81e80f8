"""Single-process serving facade (counterpart of a3vlm_tpu/serving.py; the
reference's model/accessory/model/multi_gpu_wrapper.py):

- builds or loads a ``MetaModel``,
- places its weights: on one device as they are, or, with
  ``model_parallel_size > 1``, split over a ("data", "model") mesh of one
  process per device,
- exposes the same generate / stream_generate / compute_logits /
  evaluate_examples surface with host-side image arrays.

On several devices the server keeps the reference wrapper's shape
(multi_gpu_wrapper.py:49-116, :143-320): the caller's process is rank 0; it
spawns the other ranks (``parallel.launch``), sends each call to them over
the gloo control group, every rank runs the same generation loop in
lockstep over its shard, and rank 0 returns the result. The ranks stop on
``close()``, at exit, and when a call fails on rank 0.
"""

from __future__ import annotations

import atexit
from typing import Iterable, List, Optional, Sequence

import numpy as np
import torch


def _sharded_families(llama_type: str) -> bool:
    """The families the JAX server places on its mesh (serving.py:80-87);
    the others are served unsharded."""
    return llama_type.startswith("llama_ens5") or llama_type == "llama"


def partition_specs(model, model_parallel_size: int) -> dict:
    """The specs the JAX server gives a model's tree (serving.py:68-93):
    the family's dense specs, turned by ``quantized_partition_specs``
    where any leaf is quantized."""
    from a3vlm_tpu_torch.models import ens5 as ens5_mod
    from a3vlm_tpu_torch.models import llama as llama_mod
    from a3vlm_tpu_torch.quant import (
        QuantizedWeight,
        quantized_partition_specs,
        tree_map,
    )

    if model.llama_type.startswith("llama_ens5"):
        specs = ens5_mod.ens5_partition_specs(model.cfg, model.params)
    else:
        specs = llama_mod.llama_partition_specs(model.args)
    leaves: list = []
    tree_map(leaves.append, model.params)
    if any(isinstance(x, QuantizedWeight) for x in leaves):
        specs = quantized_partition_specs(specs, model.params,
                                          model_parallel_size)
    return specs


class ModelServer:
    def __init__(
        self,
        pretrained_path: Optional[str | list] = None,
        llama_type: Optional[str] = None,
        tokenizer_path: Optional[str] = None,
        model_parallel_size: int = 1,
        max_seq_len: int = 4096,
        quant: bool = False,
        meta_model=None,
        kv_cache_bits: Optional[int] = None,
        device: torch.device | str = "cuda",
        tokenizer=None,
        devices: Optional[Sequence[str]] = None,
    ):
        """As the JAX constructor (serving.py:21-66). ``meta_model`` is
        served as given, else ``MetaModel.from_pretrained`` loads
        ``pretrained_path`` with the vocab padded to
        ``model_parallel_size * 128``, int4 with ``quant`` (``tp_align``
        and ``row_parallel`` of the mesh, so wo / w2 become row-parallel
        chunks). ``tokenizer``, an object, stands in for
        ``tokenizer_path``.

        ``device`` is the one device of ``model_parallel_size=1``.
        ``devices``: the mesh's devices, one rank each, every visible card
        when None (as the JAX mesh takes every device); their count must
        divide by ``model_parallel_size``. A card serves two ranks only
        where ``devices`` names it twice. ``llama_ens5*`` and ``llama``
        models are split over the mesh; the others are served unsharded on
        the first device, as the JAX server leaves them."""
        from a3vlm_tpu_torch.meta import MetaModel
        from a3vlm_tpu_torch.parallel.mesh import visible_devices

        if model_parallel_size < 1:
            raise ValueError(f"model_parallel_size {model_parallel_size}")
        if model_parallel_size == 1 and devices is None:
            devices = [str(device)]
        else:
            devices = [str(d) for d in (visible_devices() if devices is None
                                        else devices)]
            if len(devices) < model_parallel_size:
                raise ValueError(
                    f"model_parallel_size {model_parallel_size} needs as "
                    f"many devices; {len(devices)} are visible")
            if len(devices) % model_parallel_size:
                raise ValueError(
                    f"device count {len(devices)} not divisible by "
                    f"model_parallel_size {model_parallel_size}")
        self.devices = devices
        self.model_parallel_size = model_parallel_size
        self.mesh = None
        self._ranks = None
        self._closed = False
        self._stream = None  # a stream rank 0's caller has not read to its end
        if meta_model is not None:
            self.model = meta_model
        else:
            self.model = MetaModel.from_pretrained(
                pretrained_path,
                llama_type=llama_type,
                tokenizer_path=tokenizer_path,
                with_visual=True,
                max_seq_len=max_seq_len,
                # mp-aligned vocab pad: the column-parallel head's shards
                # stay lane-aligned at mp > 2
                vocab_align=model_parallel_size * 128,
                device=devices[0],
                tokenizer=tokenizer,
            )
            if quant:
                mp = model_parallel_size
                self.model.quantize(tp_align=mp * 128 if mp > 1 else 0,
                                    row_parallel=mp if mp > 1 else 0)
        if kv_cache_bits is not None:
            # int8 KV cache (serving extension; ops/decode_attention.py)
            self.model.kv_cache_bits = kv_cache_bits
        self._place_params()

    @property
    def backend(self) -> Optional[str]:
        """The collectives' backend ("nccl" or "gloo"), None unsharded."""
        return None if self.mesh is None else self.mesh.backend

    def _place_params(self):
        """Split the model over the mesh (serving.py:68-96): spawn ranks
        1..n-1 with the whole model, and every rank keeps its shard. The
        cached generator is dropped, as the JAX method drops it."""
        from a3vlm_tpu_torch.parallel.launch import start_ranks

        m = self.model
        m._generator = None
        if len(self.devices) == 1 or not _sharded_families(m.llama_type):
            return
        import torch.distributed as dist

        if dist.is_initialized():
            raise ValueError("this process already holds a mesh (one "
                             "sharded server at a time: close() the other)")
        specs = partition_specs(m, self.model_parallel_size)
        self.mesh, self._ranks = start_ranks(
            self.devices, self.model_parallel_size, _serve_rank, m, specs)
        try:
            _take_shard(m, self.mesh, specs)
        except BaseException:
            self.close(force=True)
            raise
        atexit.register(self.close, force=True)

    # -- the ranks -----------------------------------------------------------

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("the server is closed: its ranks have "
                               "stopped")

    def _drain(self) -> None:
        """The other ranks run a stream to its end: so does rank 0, before
        the next call, where its caller stopped reading one."""
        stream, self._stream = self._stream, None
        if stream is not None:
            for _ in stream:
                pass

    def _call(self, name: str, *args, **kwargs):
        """Method ``name`` of the model on every rank; rank 0's result."""
        self._check_open()
        if self._ranks is None:
            return getattr(self.model, name)(*args, **kwargs)
        from a3vlm_tpu_torch.parallel.mesh import broadcast_object

        try:
            self._drain()
            broadcast_object(("call", name, args, kwargs), self.mesh)
            return _run(self.model, name, args, kwargs)
        except BaseException:
            self.close(force=True)
            raise

    def map_ranks(self, fn, *args, **kwargs) -> list:
        """``fn(model, *args, **kwargs)`` on every rank (``fn`` importable
        by the other ranks); every rank's result, in rank order. Rank 0's
        ``model`` is ``self.model``."""
        self._check_open()
        if self._ranks is None:
            return [fn(self.model, *args, **kwargs)]
        import torch.distributed as dist

        from a3vlm_tpu_torch.parallel.mesh import broadcast_object

        try:
            self._drain()
            broadcast_object(("map", fn, args, kwargs), self.mesh)
            out = [None] * self.mesh.world_size
            dist.gather_object(fn(self.model, *args, **kwargs), out, dst=0,
                               group=self.mesh.control_group)
            return out
        except BaseException:
            self.close(force=True)
            raise

    def close(self, force: bool = False) -> None:
        """Stop the other ranks and leave the mesh (``force``: without
        asking them, as after a failed call)."""
        ranks, self._ranks = self._ranks, None
        if ranks is None:
            return
        self._closed = True
        atexit.unregister(self.close)
        if not force and ranks.alive():
            from a3vlm_tpu_torch.parallel.mesh import broadcast_object

            try:
                self._drain()
                broadcast_object(None, self.mesh)
            except Exception:
                force = True
        ranks.stop(wait=0.0 if force else 30.0)

    def __del__(self):
        try:
            self.close(force=True)
        except Exception:
            pass

    # -- API (multi_gpu_wrapper.py:260-320 surface) --------------------------

    def generate(
        self,
        prompts: List[str],
        images=None,
        max_gen_len: int = 512,
        temperature: float = 0.0,
        top_p: float = 0.95,
        additional_stop_symbols: Iterable[str] = (),
        **kw,
    ) -> List[str]:
        # **kw delegation (like stream_generate below): every MetaModel
        # generate kwarg (fsm, draft_k, seed, ...) flows through without
        # this facade having to chase the signature
        if images is not None and not isinstance(images, torch.Tensor):
            images = np.asarray(images)
        return self._call(
            "generate",
            prompts,
            images=images,
            max_gen_len=max_gen_len,
            temperature=temperature,
            top_p=top_p,
            additional_stop_symbols=tuple(additional_stop_symbols),
            **kw,
        )

    def stream_generate(self, prompt: str, image=None, **kw):
        self._check_open()
        if self._ranks is None:
            yield from self.model.stream_generate(prompt, image=image, **kw)
            return
        from a3vlm_tpu_torch.parallel.mesh import broadcast_object

        try:
            self._drain()
            broadcast_object(("call", "stream_generate", (prompt,),
                              {"image": image, **kw}), self.mesh)
            self._stream = self.model.stream_generate(prompt, image=image,
                                                      **kw)
            # not ``yield from``: that would close the model's stream when
            # the caller drops this one, and leave the other ranks mid-way
            for chunk in self._stream:
                yield chunk
            self._stream = None
        except GeneratorExit:
            self._drain()
            raise
        except BaseException:
            self.close(force=True)
            raise

    def compute_logits(self, examples, images=None, **kw):
        return self._call("compute_logits", examples, images=images, **kw)

    def evaluate_examples(self, examples, contexts=None, images=None, **kw):
        return self._call("evaluate_examples", examples, contexts=contexts,
                          images=images, **kw)


def _run(model, name: str, args, kwargs):
    out = getattr(model, name)(*args, **kwargs)
    if name == "stream_generate":
        out = list(out)
    return out


def _take_shard(model, mesh, specs) -> None:
    """This rank's shard of the model's tree in place of the whole tree."""
    from a3vlm_tpu_torch.parallel.mesh import barrier, shard_params

    model.params = shard_params(model.params, mesh, specs)
    model.mesh = mesh
    model._generator = None
    # every rank holds its copy before rank 0 lets the whole tree go
    barrier(mesh)


def _serve_rank(mesh, model, specs):
    """Ranks 1..n-1 of a ``ModelServer``: take the shard, then run every
    call rank 0 sends until it sends None."""
    import torch.distributed as dist

    from a3vlm_tpu_torch.parallel.mesh import broadcast_object

    _take_shard(model, mesh, specs)
    while True:
        cmd = broadcast_object(None, mesh)
        if cmd is None:
            return None
        kind, what, args, kwargs = cmd
        if kind == "call":
            _run(model, what, args, kwargs)
        else:
            dist.gather_object(what(model, *args, **kwargs), None, dst=0,
                               group=mesh.control_group)
