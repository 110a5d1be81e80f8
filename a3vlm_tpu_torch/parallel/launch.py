"""Start the ranks of a mesh: one process per device, the caller's process
rank 0 (the reference's multi_gpu_wrapper.py spawns its ranks the same
way, serving.py:1-10).

``start_ranks`` spawns ranks 1..n-1 (``torch.multiprocessing``, spawn
context) and joins rank 0, the caller, to them; ``run_spmd`` runs one
function on every rank and returns every rank's result. Arguments reach the
other ranks pickled by torch's reducers: a CUDA tensor as a handle to the
same memory (the receiving rank copies what it keeps to its own device), a
CPU tensor through shared memory. Either way the ranks (rank 0 too) share
the storage of what they were given: a rank that updates a tensor in
place (a train step's trainables) works on its own copy. Results come back
by value (a rank may exit before rank 0 reads them).

A rank started here exits when its caller's process is gone, so no
orphan keeps a device.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import threading
import time
import traceback
from typing import Any, Callable, Optional, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as tmp_mp

from a3vlm_tpu_torch.parallel.mesh import Mesh, create_mesh, init_ranks


def _exit_with_parent(parent: int) -> None:
    def watch():
        while True:
            if os.getppid() != parent:
                os._exit(1)
            time.sleep(0.5)

    threading.Thread(target=watch, daemon=True).start()


class Ranks:
    """The processes of ranks 1..n-1 and the caller's place as rank 0."""

    def __init__(self, procs, tmpdir: str, results):
        self.procs = procs
        self.tmpdir = tmpdir
        self.results = results

    def alive(self) -> bool:
        return all(p.is_alive() for p in self.procs)

    def collect(self, n: int, timeout: float = 600.0) -> list:
        """(rank, ok, value) of ``n`` ranks, in rank order; fails if a rank
        dies without reporting."""
        got, t0 = {}, time.time()
        while len(got) < n:
            if not self.results.empty():
                rank, ok, value = self.results.get()
                got[rank] = (ok, pickle.loads(value) if ok else value)
                continue
            dead = [p for p in self.procs if p.exitcode not in (None, 0)]
            if dead and self.results.empty():
                raise RuntimeError(f"a rank exited with code "
                                   f"{dead[0].exitcode} without a result")
            if time.time() - t0 > timeout:
                raise TimeoutError("ranks did not report")
            time.sleep(0.01)
        return [got[r] for r in sorted(got)]

    def stop(self, wait: float = 30.0) -> None:
        """Join every rank (killing any still running after ``wait``
        seconds), leave the process group and remove the rendezvous."""
        deadline = time.time() + wait
        for p in self.procs:
            p.join(max(0.0, deadline - time.time()))
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(5)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(self.tmpdir, ignore_errors=True)


def _worker(rank: int, devices, init_file: str, mp_size: int, threads: int,
            target: Callable, args: tuple, results, parent: int) -> None:
    _exit_with_parent(parent)
    torch.set_num_threads(threads)
    try:
        init_ranks(rank, devices, init_file)
        mesh = create_mesh(mp_size, devices)
        # by value: a tensor shared with rank 0 would need this process
        # alive until rank 0 has read it
        value = pickle.dumps(target(mesh, *args))
        results.put((rank, True, value))
    except BaseException:  # reported to rank 0, which raises it
        results.put((rank, False, traceback.format_exc()))
        # no clean shutdown: peers waiting in a collective see this rank
        # leave and fail instead of hanging
        os._exit(1)
    dist.destroy_process_group()


def start_ranks(devices: Sequence, model_parallel_size: int,
                target: Callable, *args) -> tuple[Mesh, Ranks]:
    """Spawn ranks 1..n-1 of a mesh over ``devices``, each running
    ``target(mesh, *args)`` and putting its result on ``Ranks.results``;
    join the caller as rank 0. Returns rank 0's mesh and the ranks."""
    devices = [str(d) for d in devices]
    tmpdir = tempfile.mkdtemp(prefix="a3vlm_ranks_")
    init_file = os.path.join(tmpdir, "rendezvous")
    ctx = tmp_mp.get_context("spawn")
    results = ctx.SimpleQueue()
    procs = [ctx.Process(target=_worker, daemon=True, args=(
        r, devices, init_file, model_parallel_size, torch.get_num_threads(),
        target, args, results, os.getpid())) for r in range(1, len(devices))]
    for p in procs:
        p.start()
    ranks = Ranks(procs, tmpdir, results)
    try:
        init_ranks(0, devices, init_file)
        mesh = create_mesh(model_parallel_size, devices)
    except BaseException:
        ranks.stop(wait=0.0)
        raise
    return mesh, ranks


def run_spmd(fn: Callable, devices: Sequence, *args,
             model_parallel_size: int = 1,
             timeout: Optional[float] = None) -> list[Any]:
    """``fn(mesh, *args)`` on every rank of a mesh over ``devices`` (rank 0
    in this process); every rank's result, in rank order. A rank that
    fails makes this raise, with its traceback."""
    if len(devices) == 1:
        return [fn(create_mesh(model_parallel_size, devices), *args)]
    mesh, ranks = start_ranks(devices, model_parallel_size, fn, *args)
    try:
        try:
            value0 = fn(mesh, *args)
        except BaseException:
            # a peer's own error explains a failed collective best
            for p in ranks.procs:
                p.join(2)
            if not ranks.results.empty():
                rank, ok, value = ranks.results.get()
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
            raise
        others = ranks.collect(len(devices) - 1, timeout or 600.0)
    except BaseException:
        ranks.stop(wait=0.0)
        raise
    ranks.stop()
    for r, (ok, value) in enumerate(others, start=1):
        if not ok:
            raise RuntimeError(f"rank {r} failed:\n{value}")
    return [value0] + [v for _, v in others]
