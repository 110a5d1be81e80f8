"""The ("data", "model") mesh over processes (counterpart of
a3vlm_tpu/parallel/mesh.py).

The JAX package drives every device from one process through one 2-D
``Mesh``; XLA inserts the collectives. Here each device has a process of
its own (its rank), and the mesh is a set of ``torch.distributed`` process
groups over those ranks:

- ``model``: tensor parallelism, adjacent ranks (the JAX grid reshape puts
  the model axis on adjacent devices, mesh.py:48): rank r sits in model
  group r // mp at model index r % mp;
- ``data``: the ranks with the same model index, one per model group: the
  batch splits over it.

**The backend is chosen from the device list alone** (``choose_backend``):
NCCL where every rank has a card of its own, gloo on the CPU and where
ranks share a card (NCCL refuses two ranks on one device). A backend is
never swapped for another after a failure. Rendezvous is a file store
(``init_method="file://..."``) in a temporary directory, so nothing
listens on a port. Every rank calls ``init_ranks`` then ``create_mesh``
with the same arguments (``parallel.launch`` spawns the ranks).

Inside ``use_mesh(mesh)`` the decoders run their tensor-parallel forward
(``parallel/tp.py``) and caches hold this rank's kv heads.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass
from datetime import timedelta
from typing import Any, Optional, Sequence

import torch
import torch.distributed as dist

from a3vlm_tpu_torch.utils import trace

DATA_AXIS = "data"
MODEL_AXIS = "model"

# how long a collective may wait for a peer before it fails (a rank that
# died leaves the others waiting)
COLLECTIVE_TIMEOUT = timedelta(seconds=900)


class PartitionSpec(tuple):
    """One axis name (or None) per dimension of a leaf, as
    ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):  # unpickled as P(*axes)
        return tuple(self)


P = PartitionSpec


def choose_backend(devices: Sequence) -> str:
    """"nccl" when every device is a distinct CUDA device, else "gloo" (the
    CPU, or ranks that share a card)."""
    devs = [torch.device(d) for d in devices]
    cuda = [d for d in devs if d.type == "cuda"]
    if len(cuda) == len(devs) and len({d.index for d in cuda}) == len(devs):
        return "nccl"
    return "gloo"


def visible_devices() -> list[str]:
    """Every visible CUDA device, in order."""
    return [f"cuda:{i}" for i in range(torch.cuda.device_count())]


def init_ranks(rank: int, devices: Sequence, init_file: str) -> str:
    """Join this process to the world of ``len(devices)`` ranks as
    ``rank``, on ``devices[rank]``, through the file store at
    ``init_file``. Returns the backend."""
    backend = choose_backend(devices)
    device = torch.device(devices[rank])
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=len(devices),
                            timeout=COLLECTIVE_TIMEOUT)
    return backend


@dataclass(eq=False)
class Mesh:
    """This rank's view of the ("data", "model") mesh. ``model_group`` and
    ``data_group`` are None where their axis has one rank;
    ``control_group`` is a gloo group over every rank for host objects."""

    devices: tuple
    rank: int
    dp_size: int
    mp_size: int
    backend: str = "gloo"
    model_group: Any = None
    data_group: Any = None
    control_group: Any = None

    @property
    def device(self) -> torch.device:
        d = torch.device(self.devices[self.rank])
        if d.type == "cuda" and d.index is None:
            d = torch.device("cuda", 0)
        return d

    @property
    def world_size(self) -> int:
        return self.dp_size * self.mp_size

    @property
    def model_index(self) -> int:
        return self.rank % self.mp_size

    @property
    def data_index(self) -> int:
        return self.rank // self.mp_size

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.dp_size, MODEL_AXIS: self.mp_size}

    def axis_size(self, axis: Optional[str]) -> int:
        return self.shape.get(axis, 1) if axis else 1

    def axis_index(self, axis: Optional[str]) -> int:
        if axis == MODEL_AXIS:
            return self.model_index
        if axis == DATA_AXIS:
            return self.data_index
        return 0

    def group(self, axis: str):
        return self.model_group if axis == MODEL_AXIS else self.data_group


def create_mesh(model_parallel_size: int = 1,
                devices: Optional[Sequence] = None) -> Mesh:
    """Build the ("data", "model") mesh over ``devices`` (every visible
    CUDA device when None), model axis over adjacent ranks (mesh.py:29-49).
    Raises when the device count does not divide by
    ``model_parallel_size`` (mesh.py:43-46). Over more than one device it
    needs ``init_ranks`` first (every rank calls this with the same
    arguments, and the groups are made in the same order on each)."""
    devices = tuple(str(d) for d in (visible_devices() if devices is None
                                     else devices))
    n = len(devices)
    if n == 0 or n % model_parallel_size != 0:
        raise ValueError(
            f"device count {n} not divisible by model_parallel_size "
            f"{model_parallel_size}")
    mp, dp = model_parallel_size, n // model_parallel_size
    if n == 1:
        return Mesh(devices, 0, 1, 1)
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise ValueError(f"a mesh over {n} devices needs {n} ranks joined "
                         "by init_ranks (parallel.launch starts them)")
    rank = dist.get_rank()
    backend = dist.get_backend()
    model_group = data_group = None
    for d in range(dp):  # every rank makes every group, in one order
        ranks = list(range(d * mp, (d + 1) * mp))
        g = dist.new_group(ranks) if mp > 1 else None
        if rank in ranks:
            model_group = g
    for m in range(mp):
        ranks = list(range(m, n, mp))
        g = dist.new_group(ranks) if dp > 1 else None
        if rank in ranks:
            data_group = g
    control = (dist.group.WORLD if backend == "gloo"
               else dist.new_group(backend="gloo"))
    return Mesh(devices, rank, dp, mp, backend, model_group, data_group,
                control)


def single_device_mesh(device: str = "cuda") -> Mesh:
    """A mesh of one rank on ``device`` (mesh.py:52)."""
    return create_mesh(1, devices=[device])


@dataclass(frozen=True)
class MeshEnv:
    """The mesh and this rank's coordinates (mesh.py:70-83)."""

    mesh: Mesh

    @property
    def dp_size(self) -> int:
        return self.mesh.dp_size

    @property
    def mp_size(self) -> int:
        return self.mesh.mp_size

    @property
    def dp_index(self) -> int:
        return self.mesh.data_index

    @property
    def mp_index(self) -> int:
        return self.mesh.model_index


_CURRENT: list = [None]


def current_mesh() -> Optional[Mesh]:
    """The mesh of the innermost ``use_mesh``, or None."""
    return _CURRENT[0]


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]):
    """Run the decoders on ``mesh`` inside the block (mesh.py:86): their
    linears, caches and image crops split over it. ``None`` changes
    nothing."""
    if mesh is None:
        yield None
        return
    prev = _CURRENT[0]
    _CURRENT[0] = mesh
    try:
        yield mesh
    finally:
        _CURRENT[0] = prev


def on_mesh(method):
    """Run a method inside ``use_mesh(self.mesh)``."""

    @functools.wraps(method)
    def run(self, *args, **kwargs):
        with use_mesh(self.mesh):
            return method(self, *args, **kwargs)

    return run


def is_parallel(mesh: Optional[Mesh]) -> bool:
    return mesh is not None and mesh.world_size > 1


# ---------------------------------------------------------------- collectives
#
# gloo has no CUDA form of some collectives (its all_gather takes CPU
# tensors), so under gloo a CUDA tensor goes through host memory, both ways.
# That happens only where ranks share a card: between distinct cards the
# backend is NCCL, which takes the card's tensors as they are.


def _via_host(mesh: Mesh, x: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and x.is_cuda


def _span(fn):
    """Each call a span of the port's recorder (``utils/trace.py``) named
    ``collective:<name>`` (the collective's host time, copies through host
    memory and waits for the card included): in the open call's record,
    and in a ``torch.profiler`` trace, so a trace can take the
    collectives' share."""
    name = f"collective:{fn.__name__}"

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with trace.span(name):
            return fn(*args, **kwargs)

    return run


@_span
def all_reduce(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS
               ) -> torch.Tensor:
    """The sum of ``x`` over ``axis``; every rank of the group gets the
    same bytes. ``x`` itself is left as it was."""
    group = mesh.group(axis)
    if group is None:
        return x
    if _via_host(mesh, x):
        h = x.detach().to("cpu", copy=True)
        dist.all_reduce(h, group=group)
        return h.to(x.device)
    y = x.detach().clone()
    dist.all_reduce(y, group=group)
    return y


@_span
def all_gather(x: torch.Tensor, mesh: Mesh, dim: int = -1,
               axis: str = MODEL_AXIS) -> torch.Tensor:
    """The group's pieces of ``x`` (equal shapes) concatenated along
    ``dim`` in rank order."""
    group = mesh.group(axis)
    if group is None:
        return x
    n = mesh.axis_size(axis)
    src = x.detach().contiguous()
    if _via_host(mesh, src):
        parts = [torch.empty_like(src.cpu()) for _ in range(n)]
        dist.all_gather(parts, src.cpu(), group=group)
        return torch.cat([p.to(x.device) for p in parts], dim=dim)
    # one flat buffer, then the pieces moved to ``dim`` in one copy
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src, group=group)
    dim = dim % src.dim()
    return out.view(n, *src.shape).movedim(0, dim).reshape(
        *src.shape[:dim], n * src.shape[dim], *src.shape[dim + 1:])


@_span
def broadcast_from_first(x: torch.Tensor, mesh: Mesh,
                         axis: str = MODEL_AXIS) -> torch.Tensor:
    """The first rank of ``axis``'s group's ``x`` on every rank of the
    group (``x`` itself is left as it was)."""
    group = mesh.group(axis)
    if group is None:
        return x
    src = (mesh.data_index * mesh.mp_size if axis == MODEL_AXIS
           else mesh.model_index)
    y = x.detach().to("cpu", copy=True) if _via_host(mesh, x) \
        else x.detach().clone()
    dist.broadcast(y, src=src, group=group)
    return y.to(x.device)


@_span
def reduce_scatter(x: torch.Tensor, mesh: Mesh, dim: int = -1,
                   axis: str = MODEL_AXIS) -> torch.Tensor:
    """This rank's piece (along ``dim``, in rank order) of the sum of ``x``
    over ``axis``. gloo has no reduce-scatter: there it is the sum, then
    the piece."""
    group = mesh.group(axis)
    if group is None:
        return x
    n, i = mesh.axis_size(axis), mesh.axis_index(axis)
    dim = dim % x.dim()
    if mesh.backend == "gloo":
        a, b = split_range(x.shape[dim], n, i)
        return all_reduce.__wrapped__(x, mesh, axis).narrow(
            dim, a, b - a).contiguous()
    src = x.detach().movedim(dim, 0).contiguous()
    out = src.new_empty((src.shape[0] // n, *src.shape[1:]))
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


@_span
def all_gather_uneven(x: torch.Tensor, mesh: Mesh, counts: Sequence[int]
                      ) -> torch.Tensor:
    """Every rank's rows of ``x`` (dim 0; rank r holds ``counts[r]``)
    concatenated in rank order, over the whole mesh."""
    if mesh.world_size == 1:
        return x
    width = max(counts)
    pad = x.new_zeros((width, *x.shape[1:]))
    pad[: x.shape[0]] = x
    src = pad.cpu() if _via_host(mesh, pad) else pad
    parts = [torch.empty_like(src) for _ in counts]
    dist.all_gather(parts, src)
    return torch.cat([p[:c].to(x.device) for p, c in zip(parts, counts)])


# ----------------------------------------------- differentiable collectives
#
# The training forward runs the collectives above through these, so that
# every replicated tensor gets its whole gradient, the same bytes on every
# rank, and every split tensor this rank's block of it (what XLA's
# transposes of the JAX collectives give). Where no gradient is recorded
# (inference, the frozen towers) each is the plain collective, or nothing:
# a forward under ``torch.no_grad`` runs the collectives it ran before.


def _recording(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis):
        return all_reduce(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim, axis, scatter):
        ctx.mesh, ctx.dim, ctx.axis, ctx.scatter = mesh, dim, axis, scatter
        return all_gather(x, mesh, dim, axis)

    @staticmethod
    def backward(ctx, g):
        mesh, dim, axis = ctx.mesh, ctx.dim, ctx.axis
        if ctx.scatter:
            return reduce_scatter(g, mesh, dim, axis), None, None, None, None
        a, b = split_range(g.shape[dim], mesh.axis_size(axis),
                           mesh.axis_index(axis))
        return g.narrow(dim, a, b - a), None, None, None, None


class _GatherUneven(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, counts):
        ctx.mesh, ctx.counts = mesh, counts
        return all_gather_uneven(x, mesh, counts)

    @staticmethod
    def backward(ctx, g):
        a = sum(ctx.counts[: ctx.mesh.rank])
        return g[a: a + ctx.counts[ctx.mesh.rank]], None, None


def copy_to(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS
            ) -> torch.Tensor:
    """``x`` as it is, its gradient summed over ``axis``: the input of
    products that differ by rank (a column-parallel linear's), whose
    gradients are each rank's part of ``x``'s."""
    if mesh.group(axis) is None or not _recording(x):
        return x
    return _CopyToModel.apply(x, mesh, axis)


def reduce_from(x: torch.Tensor, mesh: Mesh, axis: str = MODEL_AXIS
                ) -> torch.Tensor:
    """``all_reduce`` whose gradient passes as it is: the sum of the
    ranks' partials (a row-parallel product's), consumed the same on every
    rank."""
    if mesh.group(axis) is None or not _recording(x):
        return all_reduce(x, mesh, axis)
    return _ReduceFromModel.apply(x, mesh, axis)


def gather(x: torch.Tensor, mesh: Mesh, dim: int = -1,
           axis: str = MODEL_AXIS, consumer_replicated: bool = True
           ) -> torch.Tensor:
    """``all_gather`` with its gradient: this rank's slice of it where the
    gathered tensor is consumed the same on every rank, the reduce-scatter
    of it where each rank consumes it in a product of its own (the rank's
    gradient is then a part of the whole)."""
    if mesh.group(axis) is None or not _recording(x):
        return all_gather(x, mesh, dim, axis)
    return _Gather.apply(x, mesh, dim % x.dim(), axis,
                         not consumer_replicated)


def gather_uneven(x: torch.Tensor, mesh: Mesh, counts: Sequence[int]
                  ) -> torch.Tensor:
    """``all_gather_uneven`` with its gradient: this rank's rows (the
    gathered rows are consumed the same on every rank)."""
    if mesh.world_size == 1 or not _recording(x):
        return all_gather_uneven(x, mesh, counts)
    return _GatherUneven.apply(x, mesh, list(counts))


def broadcast_object(obj: Any, mesh: Mesh, src: int = 0) -> Any:
    """``obj`` of rank ``src`` on every rank, over the gloo control
    group."""
    if mesh.world_size == 1:
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=mesh.control_group)
    return box[0]


def barrier(mesh: Mesh) -> None:
    if mesh.world_size > 1:
        dist.barrier(group=mesh.control_group)


# ---------------------------------------------------------------- placement


def split_range(n: int, parts: int, index: int) -> tuple[int, int]:
    """[start, stop) of piece ``index`` of ``parts`` equal pieces of n."""
    if n % parts:
        raise ValueError(f"{n} does not split into {parts} equal shards")
    step = n // parts
    return index * step, (index + 1) * step


def local_slice(x: torch.Tensor, spec: Optional[Sequence], mesh: Mesh
                ) -> torch.Tensor:
    """This rank's block of ``x`` under ``spec`` (a copy where a dim is
    split, so the full leaf can be freed)."""
    out = x
    for dim, axis in enumerate(spec or ()):
        if axis is None or mesh.axis_size(axis) == 1:
            continue
        a, b = split_range(x.shape[dim], mesh.axis_size(axis),
                           mesh.axis_index(axis))
        out = out.narrow(dim, a, b - a)
    if out is not x:
        out = out.contiguous().clone()
    return out


def shard_params(params, mesh: Mesh, spec_tree):
    """This rank's part of a full parameter tree (mesh.py:58): each leaf
    sliced by its spec and moved to this rank's device; decoder linears
    split over "model" become ``tp.Shard`` leaves, which record which
    dimension they split. A replicated leaf already on the device is kept
    as it is (not copied)."""
    from a3vlm_tpu_torch.parallel import tp

    return tp.shard_tree(params, mesh, spec_tree)
