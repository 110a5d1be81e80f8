"""Checkpoint and resume of the port (counterpart of
a3vlm_tpu/checkpoint/manager.py), under the JAX package's directory
contract with files of its own:

- one directory per checkpoint, ``epoch_X`` or ``epoch_X-iter_Y``
  (in-epoch saves), found again by ``find_latest_checkpoint``, which takes
  only a directory holding ``_DONE``;
- ``model.pt``: the parameter tree in the JAX package's layout
  (``bridge.params_to_host``: the decoder's and the adapters' layers
  stacked on axis 0, linears [in, out], conv kernels HWIO), every tensor
  in its own dtype, written with ``torch.save`` and read with
  ``torch.load(..., weights_only=True)``. Under a ``trainable_mask`` a
  frozen leaf is not stored: it is a ``None`` hole, which a restore fills
  from the live tree (``only_save_trainable``);
- ``optimizer.pt``: the ``AdamWState`` (``count``, ``mu``, ``nu``) in the
  same layout;
- the sidecars ``other.json`` (epoch, iter, step), ``dataset_state.json``,
  ``config.json``, ``meta.json`` and the tokenizer's files.

Neither package reads the other's files: the JAX package writes Orbax
directories, which need JAX to read.

A save with ``wait=False`` is asynchronous, as Orbax's is: the tensors are
copied to the host before ``save`` returns (the optimizer updates the
parameters and moments in place, so the next step may start at once), and
a background thread writes the files; ``_DONE`` is touched once the write
has finished, on the next ``save`` or on ``wait_until_finished()``.

Resume has two stages: ``restore_params`` (the model) and
``restore_train_state`` (optimizer state, counters, dataset state).

On a mesh of several ranks (``CheckpointManager(mesh=)``) every rank calls
``save``: the leaves split over "model" (``parallel.tp.Shard``: the
parameters, the adapters, the moments) are gathered whole, collectively,
on the calling thread, and rank 0 alone writes the files a one-device save
writes; the other ranks write nothing. ``wait_until_finished`` is a
barrier of every rank after rank 0's write has finished and ``_DONE`` is
there. A restore reads the whole leaves on every rank and each takes its
block of a split leaf (the block the live leaf holds), so a checkpoint
saved on one mesh resumes on any other, or on one device."""

from __future__ import annotations

import json
import os
import re
import threading
import time
from pathlib import Path
from typing import Any, Optional

import torch

from a3vlm_tpu_torch.checkpoint.bridge import params_from_host, params_to_host
from a3vlm_tpu_torch.parallel.mesh import barrier as mesh_barrier
from a3vlm_tpu_torch.parallel.mesh import is_parallel
from a3vlm_tpu_torch.parallel.tp import Shard, gather_shard, local_weight
from a3vlm_tpu_torch.quant import QuantizedWeight

MODEL_FILE = "model.pt"
OPTIMIZER_FILE = "optimizer.pt"


def _ckpt_name(epoch: int, it: Optional[int] = None) -> str:
    # misc.py naming: epoch_X or epoch_X-iter_Y (in-epoch saves)
    return f"epoch_{epoch}" if it is None else f"epoch_{epoch}-iter_{it}"


_CKPT_RE = re.compile(r"^epoch_(\d+)(?:-iter_(\d+))?$")


def find_latest_checkpoint(output_dir: str) -> Optional[str]:
    """Latest-checkpoint discovery (misc.py:440-464): highest epoch, then
    highest iter (a full epoch save beats in-epoch saves of that epoch)."""
    if not os.path.isdir(output_dir):
        return None
    best = None
    for name in os.listdir(output_dir):
        m = _CKPT_RE.match(name)
        if not m or not (Path(output_dir) / name / "_DONE").exists():
            continue
        epoch = int(m.group(1))
        it = int(m.group(2)) if m.group(2) else None
        key = (epoch, it is None, it or 0)
        if best is None or key > best[0]:
            best = (key, name)
    return str(Path(output_dir) / best[1]) if best else None


class _Write:
    """One checkpoint's files, written by a thread of its own."""

    def __init__(self, ckpt_dir: Path, files: dict[str, Any]):
        self.ckpt_dir = ckpt_dir
        self.error: Optional[BaseException] = None
        self.seconds = 0.0  # the thread's time for the files
        self.thread = threading.Thread(target=self._run, args=(files,),
                                       daemon=True)
        self.thread.start()

    def _run(self, files: dict[str, Any]) -> None:
        t0 = time.perf_counter()
        try:
            for name, obj in files.items():
                tmp = self.ckpt_dir / (name + ".tmp")
                torch.save(obj, tmp)
                os.replace(tmp, self.ckpt_dir / name)
        except BaseException as e:  # re-raised by finish()
            self.error = e
        self.seconds = time.perf_counter() - t0

    def finish(self) -> None:
        self.thread.join()
        if self.error is not None:
            raise RuntimeError(f"checkpoint write to {self.ckpt_dir} "
                               "failed") from self.error
        (self.ckpt_dir / "_DONE").touch()


class CheckpointManager:
    def __init__(self, output_dir: str, mesh=None):
        """``mesh``: the mesh whose ranks each hold a shard of the state
        (every rank makes its manager; rank 0 writes)."""
        self.output_dir = Path(output_dir)
        self.mesh = mesh if is_parallel(mesh) else None
        self.writes = self.mesh is None or self.mesh.rank == 0
        if self.writes:
            self.output_dir.mkdir(parents=True, exist_ok=True)
        self._pending: Optional[_Write] = None
        # seconds the last finished save's files took to write
        self.last_write_seconds: Optional[float] = None

    # -- save ----------------------------------------------------------------

    def save(
        self,
        epoch: int,
        it: Optional[int] = None,
        *,
        params: Any,
        opt_state: Any = None,
        step: Any = None,
        dataset_state: Optional[dict] = None,
        tokenizer=None,
        llama_type: Optional[str] = None,
        llama_config: Optional[dict] = None,
        trainable_mask: Optional[Any] = None,
        extra: Optional[dict] = None,
        wait: bool = True,
    ) -> str:
        """Writes ``epoch_{epoch}[-iter_{it}]`` (manager.py:61).
        ``opt_state`` is an ``AdamWState``. ``wait=False`` returns once
        the tensors are on the host and leaves the write to a thread;
        ``_DONE`` follows on the next save or ``wait_until_finished()``.
        Resume never sees a torn checkpoint: ``find_latest_checkpoint``
        requires ``_DONE``. A packed base cannot be stored: save with the
        ``trainable_mask`` that freezes it. On a mesh every rank calls it
        (the module's notes)."""
        self.wait_until_finished()
        ckpt_dir = self.output_dir / _ckpt_name(epoch, it)
        if trainable_mask is not None:
            # only_save_trainable (misc.py:347-353): frozen leaves dropped
            params = _filter_by_mask(params, trainable_mask)
        _refuse_packed(params)
        params = self._whole(params)
        if opt_state is not None:
            mu, nu = self._whole(opt_state.mu), self._whole(opt_state.nu)
        if not self.writes:
            if wait:
                self.wait_until_finished()
            return str(ckpt_dir)
        ckpt_dir.mkdir(parents=True, exist_ok=True)
        (ckpt_dir / "_DONE").unlink(missing_ok=True)
        files = {MODEL_FILE: params_to_host(params)}
        if opt_state is not None:
            files[OPTIMIZER_FILE] = {
                "count": int(opt_state.count),
                "mu": params_to_host(mu),
                "nu": params_to_host(nu),
            }
        other = {
            "epoch": epoch,
            "iter": it if it is not None else 0,
            "step": int(step) if step is not None else 0,
        }
        if extra:
            other.update(extra)
        with open(ckpt_dir / "other.json", "w") as f:
            json.dump(other, f)
        if dataset_state is not None:
            with open(ckpt_dir / "dataset_state.json", "w") as f:
                json.dump(dataset_state, f)
        # self-describing sidecars (misc.py:366-386)
        if llama_config is not None:
            with open(ckpt_dir / "config.json", "w") as f:
                json.dump(llama_config, f)
        if llama_type is not None:
            with open(ckpt_dir / "meta.json", "w") as f:
                json.dump({"llama_type": llama_type}, f)
        if tokenizer is not None:
            tokenizer.save(str(ckpt_dir))
        self._pending = _Write(ckpt_dir, files)
        if wait:
            self.wait_until_finished()
        return str(ckpt_dir)

    def wait_until_finished(self, barrier: bool = True) -> None:
        """Finalize an outstanding async save (write barrier + _DONE); on
        a mesh, with ``barrier``, a barrier of every rank after it."""
        pending, self._pending = self._pending, None
        if pending is not None:
            pending.finish()
            self.last_write_seconds = pending.seconds
        if barrier and self.mesh is not None:
            mesh_barrier(self.mesh)

    def _whole(self, tree: Any) -> Any:
        """``tree`` with every ``Shard`` gathered to its whole leaf (every
        rank, in the same order)."""
        if isinstance(tree, dict):
            return {k: self._whole(v) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return [self._whole(v) for v in tree]
        if isinstance(tree, Shard):
            return gather_shard(tree, self.mesh)
        return tree

    # -- restore ---------------------------------------------------------------

    def restore_params(self, ckpt_dir: str, params: Any) -> Any:
        """Stage-1 resume (misc.py:466-497): the stored leaves over
        ``params`` (the live tree, in the port's layout), each on the
        device and in the dtype of the leaf it replaces; a hole keeps the
        live leaf. Returns a new tree: the live one is not changed."""
        return _merge_partial(params, _to_live(restore_raw_checkpoint(
            ckpt_dir), params))

    def restore_train_state(self, ckpt_dir: str,
                            opt_state: Any = None) -> dict:
        """Stage-2 resume (misc.py:499-569): ``other.json``'s counters,
        the dataset state and, given the live ``AdamWState``, the stored
        one over it as ``"opt_state"`` (new tensors where it has a
        moment)."""
        from a3vlm_tpu_torch.train.step import AdamWState

        out: dict = {}
        opt_path = Path(ckpt_dir) / OPTIMIZER_FILE
        if opt_state is not None and opt_path.exists():
            stored = torch.load(opt_path, weights_only=True)
            out["opt_state"] = AdamWState(
                stored["count"],
                _merge_partial(opt_state.mu,
                               _to_live(stored["mu"], opt_state.mu)),
                _merge_partial(opt_state.nu,
                               _to_live(stored["nu"], opt_state.nu)))
        with open(Path(ckpt_dir) / "other.json") as f:
            out.update(json.load(f))
        ds_path = Path(ckpt_dir) / "dataset_state.json"
        if ds_path.exists():
            with open(ds_path) as f:
                out["dataset_state"] = json.load(f)
        return out


def restore_raw_checkpoint(ckpt_dir: str) -> Any:
    """A checkpoint's model tree as stored: the JAX package's layout,
    tensors on the host, frozen leaves ``None`` (manager.py:166). For
    consuming trainable-only (adapter) checkpoints whose shape the caller
    does not know up front."""
    return torch.load(Path(ckpt_dir) / MODEL_FILE, weights_only=True)


def _leaf_device(tree: Any) -> Optional[torch.device]:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            d = _leaf_device(v)
            if d is not None:
                return d
        return None
    if isinstance(tree, Shard):
        tree = tree.local
    if isinstance(tree, QuantizedWeight):
        return tree.q.device
    return None if tree is None else tree.device


def _to_live(stored: Any, live: Any) -> Any:
    """A stored tree in the port's layout on the live tree's device."""
    return params_from_host(stored, device=_leaf_device(live) or "cpu")


def _refuse_packed(tree: Any) -> None:
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            _refuse_packed(v)
    elif isinstance(local_weight(tree), QuantizedWeight):
        raise ValueError("a packed base is frozen: save with the "
                         "trainable_mask that leaves it out")


def _filter_by_mask(tree, mask):
    if isinstance(tree, dict):
        return {k: _filter_by_mask(v, mask[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_filter_by_mask(v, m) for v, m in zip(tree, mask)]
    return tree if mask else None


def _merge_partial(base, partial):
    """``partial`` over ``base``: a hole (``None``, also a whole subtree)
    keeps the base; a stored leaf takes the base leaf's dtype and must
    have its shape; a ``Shard`` takes its block of the stored whole
    leaf."""
    if partial is None:
        return base
    if isinstance(base, dict):
        return {k: _merge_partial(v, partial.get(k)) for k, v in base.items()}
    if isinstance(base, (list, tuple)):
        if len(partial) != len(base):
            raise ValueError(f"{len(partial)} stored layers, {len(base)} "
                             "live")
        return [_merge_partial(b, p) for b, p in zip(base, partial)]
    if isinstance(base, Shard) and not isinstance(base.local,
                                                  QuantizedWeight):
        return base.with_local(_merge_partial(base.local,
                                              base.take(partial)))
    if base is None or isinstance(base, (QuantizedWeight, Shard)):
        raise ValueError("a stored leaf where the live tree has "
                         f"{type(base).__name__}")
    if tuple(partial.shape) != tuple(base.shape):
        raise ValueError(f"stored shape {tuple(partial.shape)}, live "
                         f"{tuple(base.shape)}")
    return partial.to(base.dtype)
