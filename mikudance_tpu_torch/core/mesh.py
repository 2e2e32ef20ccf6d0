"""Process meshes and their collectives over ``torch.distributed``.

Port of ``mikudance_tpu/core/mesh.py``. One process is one device. Where the
JAX package runs a ``shard_map`` over a ``jax.sharding.Mesh``, the port runs
the same program on every rank of a process group, each rank computing its
shard; the collectives below rebuild what ``shard_map``'s ``out_specs`` give,
so that every rank ends with the whole result.

- ``Mesh``: a grid of global ranks with named axes, and one process group per
  line of each axis, plus one over the whole grid (axis ``None``: the grid
  flattened in row-major order, as the JAX package's ``P((win, frame))``).
  Building one is collective: every rank of the default group builds every
  mesh, in the same order, since ``dist.new_group`` must be called by all.
- its collectives: ``all_gather`` and ``all_to_all`` (``jax.lax.all_gather`` /
  ``all_to_all`` with ``tiled=True``), ``exchange`` (rows to each rank in
  sizes of their own), ``psum``, ``index`` (``axis_index``),
  ``halo`` (the neighbours' edge frames of a ``ppermute`` pair) and
  ``broadcast``. Gloo's point-to-point takes no CUDA tensor: there a CUDA
  tensor is staged through host memory, which changes the transport only
  (its collectives take CUDA tensors and copy through the host themselves).
  With gradients on and an input that needs one, ``all_to_all``,
  ``all_gather`` and ``psum`` are autograd functions whose backward is the
  transpose ``shard_map`` takes: the inverse ``all_to_all``, the sum of
  every rank's cotangent sliced to this rank's part (``reduce_scatter`` on
  NCCL; ``all_reduce`` and a slice on gloo, which has no reduce-scatter),
  and a ``psum``. Without them the forward is the same call.
  ``reduce_scatter`` (the same fallback on gloo) and ``gather_first`` (to
  the axis's first rank) serve the ZeRO optimizer.
- the training half: ``shard_train_batch`` (this rank's slice of a global
  batch: the (B, T, ...) streams over ('data', 'frame'), per-sample arrays
  over 'data'), ``zero_shard_plan`` / ``zero_shard_state`` (the JAX
  package's ZeRO rule: each leaf along its largest dimension that ``n``
  divides, replicated otherwise), ``all_reduce_`` (in place) and
  ``gather_parts`` for the optimizer.
- ``choose_2d_mesh`` / ``choose_train_mesh``: the JAX package's choice of
  axis sizes for the same ``n``, including a subset of the ranks.
- ``init_from_env``: the process group under ``torchrun``; ``spawn``: ranks
  as local processes in a process group of their own (tests on the CPU over
  gloo, several ranks on one card).

A rank's shard is a slice by its coordinate: there is no counterpart of
``shard_batch`` or ``replicate``, and the module weights stay whole on every
rank (the JAX package also shards the parameters and lets XLA gather them;
the port shards the optimizer state only).
"""

from __future__ import annotations

import os
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
WIN_AXIS = "win"  # CFG x sliding-window batch axis
FRAME_AXIS = "frame"  # frames within a window (sequence parallelism)


def pad_to_multiple(n: int, m: int) -> int:
    return ((n + m - 1) // m) * m


def _world() -> Tuple[int, int]:
    """(this rank, world size); (0, 1) without a process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


class Mesh:
    """A grid of global ranks with named axes (the port's ``jax.sharding.Mesh``).

    ``lines(axis)`` are the rank tuples along ``axis`` (``None``: the whole
    grid, row-major), one process group each. Groups are made only where a
    process group of more than one rank exists, so a mesh can be built and
    read without one; a rank outside the grid holds no group of it."""

    def __init__(self, ranks, axis_names: Sequence[str]):
        grid = np.asarray(ranks, dtype=np.int64)
        if grid.ndim != len(axis_names):
            raise ValueError(f"a {grid.ndim}-D rank grid for the axes {tuple(axis_names)}")
        self.ranks = grid
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, grid.shape))
        self.size = int(grid.size)
        self.rank, world = _world()
        if world > 1 and not set(grid.flat) <= set(range(world)):
            raise ValueError(f"ranks {sorted(set(grid.flat))} outside a world of {world}")
        self.backend = dist.get_backend() if world > 1 else None
        self._groups = {}  # axis -> (group, line) of this rank
        if world > 1:
            for axis in self.axis_names + (None,):
                for line in self.lines(axis):
                    if len(line) > 1:
                        group = dist.new_group(list(line))
                        if self.rank in line:
                            self._groups[axis] = (group, line)

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks {self.ranks.reshape(-1).tolist()})"

    def lines(self, axis: Optional[str]) -> List[Tuple[int, ...]]:
        if axis is None:
            return [tuple(int(r) for r in self.ranks.reshape(-1))]
        moved = np.moveaxis(self.ranks, self.axis_names.index(axis), -1)
        return [tuple(int(r) for r in line) for line in moved.reshape(-1, moved.shape[-1])]

    def __contains__(self, rank: int) -> bool:
        return bool((self.ranks == rank).any())

    def coords(self, rank: Optional[int] = None) -> Dict[str, int]:
        """The coordinate of ``rank`` (default: this one) on each axis."""
        where = np.argwhere(self.ranks == (self.rank if rank is None else rank))
        if not len(where):
            raise ValueError(f"rank {rank} is not in {self}")
        return dict(zip(self.axis_names, (int(i) for i in where[0])))

    def axis_size(self, axis: Optional[str] = None) -> int:
        return self.size if axis is None else self.shape[axis]

    def index(self, axis: Optional[str] = None) -> int:
        """``jax.lax.axis_index``: this rank's position along ``axis`` (its
        row-major position in the grid for ``None``)."""
        if axis is None:
            return int(np.flatnonzero(self.ranks.reshape(-1) == self.rank)[0])
        return self.coords()[axis]

    # ------------------------------------------------------------ collectives
    def _group(self, axis):
        if axis not in self._groups:
            raise RuntimeError(f"rank {self.rank} has no process group on axis {axis!r} of "
                               f"{self}")
        return self._groups[axis][0]

    def _staged(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as ``isend`` / ``irecv`` and ``gather`` take it: contiguous,
        and in host memory on gloo, whose point-to-point and gather take no
        CUDA tensor."""
        x = x.contiguous()
        return x.cpu() if x.is_cuda and self.backend == "gloo" else x

    def all_gather(self, x: torch.Tensor, axis: Optional[str] = None, dim: int = 0):
        """Every rank's ``x`` along ``axis``, concatenated along ``dim`` in
        axis order (``all_gather(tiled=True)``). Its backward hands each rank
        the sum of every rank's cotangent of its part."""
        if self.axis_size(axis) == 1:
            return x
        if _needs_grad(x):
            return _AllGather.apply(x, self, axis, dim)
        return torch.cat(self.gather_parts(x, axis), dim=dim)

    def gather_parts(self, x: torch.Tensor, axis: Optional[str] = None) -> List[torch.Tensor]:
        """Every rank's ``x`` along ``axis``, in axis order (no autograd)."""
        src = x.contiguous()
        if self.axis_size(axis) == 1:
            return [src]
        parts = [torch.empty_like(src) for _ in range(self.axis_size(axis))]
        dist.all_gather(parts, src, group=self._group(axis))
        return parts

    def gather_first(self, x: torch.Tensor,
                     axis: Optional[str] = None) -> Optional[List[torch.Tensor]]:
        """Every rank's ``x`` along ``axis``, in axis order, on the axis's
        first rank alone (None on the others): a ``gather``, through host
        memory on gloo."""
        src = self._staged(x)
        if self.axis_size(axis) == 1:
            return [src]
        group, line = self._group(axis), self._groups[axis][1]
        first = self.rank == line[0]
        parts = [torch.empty_like(src) for _ in line] if first else None
        dist.gather(src, parts, dst=line[0], group=group)
        return parts

    def all_to_all(self, x: torch.Tensor, axis: str, split_dim: int, concat_dim: int):
        """``all_to_all(tiled=True)``: ``x`` split along ``split_dim`` into one
        part per rank of ``axis``; part j goes to rank j, and the parts a rank
        receives are concatenated along ``concat_dim`` in axis order. Its
        backward is the inverse ``all_to_all``."""
        if self.axis_size(axis) == 1:
            return x
        if _needs_grad(x):
            return _AllToAll.apply(x, self, axis, split_dim, concat_dim)
        return self.all_to_all_values(x, axis, split_dim, concat_dim)

    def all_to_all_values(self, x: torch.Tensor, axis: str, split_dim: int,
                          concat_dim: int) -> torch.Tensor:
        """``all_to_all``'s forward alone: its result carries no gradient."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        moved = x.movedim(split_dim, 0)
        if moved.shape[0] % n:
            raise ValueError(f"dim {split_dim} of {tuple(x.shape)} does not split {n} ways")
        src = moved.reshape((n, moved.shape[0] // n) + moved.shape[1:]).contiguous()
        out = torch.empty_like(src)
        dist.all_to_all_single(out, src, group=self._group(axis))
        return torch.cat([out[j].movedim(0, split_dim) for j in range(n)], dim=concat_dim)

    def exchange(self, x: torch.Tensor, send: Sequence[int], recv: Sequence[int]):
        """Rows of ``x`` to every rank of the grid: its first ``send[0]`` rows
        to grid index 0, the next ``send[1]`` to index 1, and so on; returns
        the rows received, ``recv[j]`` from index j, in grid order (an
        ``all_to_all`` with split sizes)."""
        if self.size == 1:
            return x
        src = x.contiguous()
        out = src.new_empty((sum(recv),) + src.shape[1:])
        dist.all_to_all_single(out, src, list(recv), list(send), group=self._group(None))
        return out

    def psum(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """The sum of every rank's ``x`` along ``axis``; its backward is a
        ``psum`` of the cotangents."""
        if self.axis_size(axis) == 1:
            return x
        if _needs_grad(x):
            return _Psum.apply(x, self, axis)
        # all_reduce writes in place
        return self.all_reduce_(x.clone(memory_format=torch.contiguous_format), axis)

    def all_reduce_(self, x: torch.Tensor, axis: Optional[str] = None) -> torch.Tensor:
        """``x`` (contiguous) replaced by the sum over ``axis``, in place."""
        if self.axis_size(axis) > 1:
            dist.all_reduce(x, group=self._group(axis))
        return x

    def reduce_scatter(self, x: torch.Tensor, axis: Optional[str] = None,
                       dim: int = 0) -> torch.Tensor:
        """The sum over ``axis`` of every rank's ``x``, of which this rank
        keeps its part along ``dim`` (``x.shape[dim]`` split one part a
        rank). NCCL's ``reduce_scatter``; on gloo, which has none, an
        ``all_reduce`` and a slice."""
        n = self.axis_size(axis)
        if n == 1:
            return x
        if x.shape[dim] % n:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split {n} ways")
        part = x.shape[dim] // n
        if self.backend == "nccl":
            src = x.movedim(dim, 0).contiguous()
            out = src.new_empty((part,) + src.shape[1:])
            dist.reduce_scatter_tensor(out, src, group=self._group(axis))
            return out.movedim(0, dim)
        summed = self.all_reduce_(x.contiguous().clone(), axis)
        return summed.narrow(dim, self.index(axis) * part, part)

    def halo(self, x: torch.Tensor, axis: Optional[str] = None):
        """(left, right): the last slice along dim 0 of the previous rank on
        ``axis`` and the first one of the next, each keeping dim 0 (size 1);
        zeros at the ends of the axis, as a ``ppermute`` with no source gives
        (the zero padding of a temporal convolution). Point to point: each
        rank sends two slices and receives two."""
        n, i = self.axis_size(axis), self.index(axis)
        zero = torch.zeros_like(x[:1])
        if n == 1:
            return zero, zero
        group, line = self._group(axis), self._groups[axis][1]
        ops, got = [], {}
        for side, j, edge in (("left", i - 1, x[:1]), ("right", i + 1, x[-1:])):
            if 0 <= j < n:
                edge = self._staged(edge)
                got[side] = torch.empty_like(edge)
                ops += [dist.P2POp(dist.isend, edge, line[j], group),
                        dist.P2POp(dist.irecv, got[side], line[j], group)]
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        return tuple(got[side].to(x.device) if side in got else zero
                     for side in ("left", "right"))

    def broadcast(self, x: torch.Tensor, src: int) -> torch.Tensor:
        """``x`` of global rank ``src`` on every rank of the grid (each passes
        a tensor of the same shape and type)."""
        if self.size == 1:
            return x
        y = x.contiguous()
        dist.broadcast(y, src=src, group=self._group(None))
        return y


def _needs_grad(x: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and x.requires_grad


class _AllToAll(torch.autograd.Function):
    """``Mesh.all_to_all`` with its transpose, the inverse ``all_to_all``."""

    @staticmethod
    def forward(ctx, x, mesh, axis, split_dim, concat_dim):
        ctx.mesh, ctx.axis, ctx.dims = mesh, axis, (split_dim, concat_dim)
        return mesh.all_to_all_values(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        split_dim, concat_dim = ctx.dims
        return ctx.mesh.all_to_all_values(g, ctx.axis, concat_dim, split_dim), None, None, None, \
            None


class _AllGather(torch.autograd.Function):
    """``Mesh.all_gather`` with its transpose: the sum over the axis of every
    rank's cotangent, this rank's part of it."""

    @staticmethod
    def forward(ctx, x, mesh, axis, dim):
        ctx.mesh, ctx.axis, ctx.dim = mesh, axis, dim
        return torch.cat(mesh.gather_parts(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.reduce_scatter(g, ctx.axis, ctx.dim), None, None, None


class _Psum(torch.autograd.Function):
    """``Mesh.psum``; its transpose is a ``psum`` of the cotangents."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return mesh.all_reduce_(x.clone(memory_format=torch.contiguous_format), axis)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_(g.clone(memory_format=torch.contiguous_format),
                                    ctx.axis), None, None


class Axis(NamedTuple):
    """One axis of a mesh (``name=None``: the whole grid flattened), as a
    module that shards over it sees it: the JAX modules' ``frame_axis``."""

    mesh: Mesh
    name: Optional[str] = None

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.name)

    def index(self) -> int:
        return self.mesh.index(self.name)

    def all_gather(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        return self.mesh.all_gather(x, self.name, dim)

    def all_to_all(self, x: torch.Tensor, split_dim: int, concat_dim: int) -> torch.Tensor:
        return self.mesh.all_to_all(x, self.name, split_dim, concat_dim)

    def psum(self, x: torch.Tensor) -> torch.Tensor:
        return self.mesh.psum(x, self.name)

    def halo(self, x: torch.Tensor):
        return self.mesh.halo(x, self.name)


def make_mesh(ranks: Optional[Sequence[int]] = None, axis_name: str = DATA_AXIS) -> Mesh:
    """1-D mesh over all (or the given) ranks of the process group; a mesh of
    one without a process group."""
    if ranks is None:
        ranks = range(_world()[1])
    return Mesh(list(ranks), (axis_name,))


def _choose_2d_shape(n: int, sizes: Tuple[int, int]) -> Optional[Tuple[int, int]]:
    """Largest d0 * d1 <= n with d0 | sizes[0] and d1 | sizes[1], ties broken
    toward more shards on axis 0 (the collective-free axis of both callers).
    None when only one rank would be used."""
    best = (1, 1)
    for d0 in range(1, n + 1):
        if sizes[0] % d0:
            continue
        for d1 in range(1, n // d0 + 1):
            if sizes[1] % d1:
                continue
            if (d0 * d1, d0) > (best[0] * best[1], best[0]):
                best = (d0, d1)
    return None if best[0] * best[1] <= 1 else best


def _choose_2d_mesh(ranks: Sequence[int], sizes: Tuple[int, int],
                    axis_names: Tuple[str, str]) -> Optional[Mesh]:
    ranks = [int(r) for r in ranks]
    shape = _choose_2d_shape(len(ranks), sizes)
    if shape is None:
        return None
    return Mesh(np.asarray(ranks[: shape[0] * shape[1]]).reshape(shape), axis_names)


def choose_2d_mesh(ranks: Sequence[int], batch: int, frames: int) -> Optional[Mesh]:
    """('win', 'frame') mesh for the inference UNet batch (2*nw, wf, ...): the
    window / CFG axis needs no collective, the frame axis one all_to_all pair
    per motion module, so window shards come first (30-frame windows on 8
    ranks use 6). Collective where a process group exists."""
    return _choose_2d_mesh(ranks, (batch, frames), (WIN_AXIS, FRAME_AXIS))


def choose_train_mesh(ranks: Sequence[int], batch: int, frames: int) -> Optional[Mesh]:
    """('data', 'frame') mesh for a training batch (B, T, ...): data shards
    first, then frame shards (one 20-frame sample cannot split over data)."""
    return _choose_2d_mesh(ranks, (batch, frames), (DATA_AXIS, FRAME_AXIS))


# ------------------------------------------------------------ training half

FRAME_SHARDED_KEYS = ("latents", "cond20", "motion")


def shard_slice(x: torch.Tensor, mesh: Mesh, axis: str, dim: int) -> torch.Tensor:
    """This rank's consecutive part of ``x`` along ``dim``, one part a rank of
    ``axis`` (the whole of ``x`` on an axis of one, or one the mesh lacks)."""
    n = mesh.shape.get(axis, 1)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split over the {n} ranks "
                         f"of axis {axis!r}")
    part = x.shape[dim] // n
    return x.narrow(dim, mesh.index(axis) * part, part)


def shard_train_batch(batch: Mapping[str, torch.Tensor], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's slice of a global training batch (the JAX package's
    ``shard_train_batch``): on a ('data', 'frame') mesh the (B, T, ...)
    streams ``latents``, ``cond20`` and ``motion`` split over both axes and
    every per-sample array (``clip_ctx``, ``uncond``, ...) over 'data' only;
    on a 1-D mesh everything splits along its first dimension."""
    if FRAME_AXIS not in mesh.axis_names:
        axis = mesh.axis_names[0]
        return {k: shard_slice(v, mesh, axis, 0) for k, v in batch.items()}
    out = {}
    for k, v in batch.items():
        v = shard_slice(v, mesh, DATA_AXIS, 0)
        if v.ndim >= 2 and k in FRAME_SHARDED_KEYS:
            v = shard_slice(v, mesh, FRAME_AXIS, 1)
        out[k] = v
    return out


def zero_shard_dim(shape: Sequence[int], n: int) -> Optional[int]:
    """The dimension along which the JAX package's ``zero_shard_state``
    shards a leaf of ``shape`` over ``n`` ranks: the largest one that ``n``
    divides and that holds at least ``n`` (the first of equal ones); None
    (replicated) for ``n = 1``, a scalar, or no such dimension."""
    best = None  # (size, dim)
    for i, d in enumerate(shape):
        if d % n == 0 and d >= n and (best is None or d > best[0]):
            best = (d, i)
    if n == 1 or len(shape) == 0 or best is None:
        return None
    return best[1]


def zero_shard_plan(tree: Mapping[str, torch.Tensor], n: int) -> Dict[str, Optional[int]]:
    """{name: ``zero_shard_dim`` of the leaf} for a dict of tensors (or of
    anything with a ``shape``)."""
    return {k: zero_shard_dim(tuple(v.shape), n) for k, v in tree.items()}


def zero_shard_state(tree: Mapping[str, torch.Tensor], mesh: Mesh,
                     axis: str = DATA_AXIS) -> Dict[str, torch.Tensor]:
    """ZeRO-style sharding over ``axis`` (the JAX package's
    ``zero_shard_state``): this rank's part of each leaf along
    ``zero_shard_dim``, the whole leaf where it is replicated."""
    n = mesh.shape.get(axis, 1)
    return {k: v if d is None else shard_slice(v, mesh, axis, d)
            for (k, v), d in zip(tree.items(), zero_shard_plan(tree, n).values())}


# ----------------------------------------------------------------- processes

def init_from_env(device: Optional[str] = None) -> Optional[torch.device]:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1): start the process group, NCCL
    where each rank has a card of its own (card ``LOCAL_RANK``), gloo for
    ``device="cpu"``. Returns the rank's device, or None without ``torchrun``
    (nothing is started)."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1:
        return None
    if device is not None and torch.device(device).type == "cpu":
        dist.init_process_group("gloo")
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device is available; pass --device cpu to run the ranks '
                           'on the CPU')
    torch.cuda.set_device(local)
    dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    return torch.device("cuda", local)


def _rank_main(rank: int, world: int, workdir: str, backend: str, target, args) -> None:
    torch.set_num_threads(1)  # ranks share the host's cores
    try:
        if backend is not None:
            dist.init_process_group(backend, init_method=f"file://{workdir}/store",
                                    world_size=world, rank=rank,
                                    timeout=timedelta(seconds=600))
        result = target(*args)
        torch.save(result, os.path.join(workdir, f"rank{rank}.pt"))
    except BaseException:
        err = os.path.join(workdir, f"rank{rank}.err")
        with open(err + ".part", "w") as f:
            f.write(f"{time.time_ns()}\n{traceback.format_exc()}")  # when, then what
        os.replace(err + ".part", err)  # never read half written
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn(world: int, target, args: tuple = (), *, backend: Optional[str] = "gloo",
          timeout: float = 600.0) -> list:
    """Run ``target(*args)`` on ``world`` local processes (spawned, one CPU
    thread each) and return each rank's result, rank by rank.

    Each process joins a process group of ``backend`` first, rendezvous
    through a file in a fresh temporary directory (so runs in parallel never
    meet); ``backend=None`` starts none (the target sets up its own).
    ``target`` must be importable by name. When a rank fails or the time
    runs out, every rank is stopped and the error raised with every failed
    rank's traceback and exit code, the first rank to fail last."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as workdir:
        procs = [ctx.Process(target=_rank_main, args=(r, world, workdir, backend, target, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        def error(r):
            """(when, traceback) of rank ``r``'s failure, or None."""
            err = os.path.join(workdir, f"rank{r}.err")
            if not os.path.exists(err):
                return None
            when, _, text = open(err).read().partition("\n")
            return int(when), text.rstrip()

        def first(bad):
            """Of the ranks that exited non-zero, and those that caught their
            error and have not exited yet, the one that failed first: a rank
            that wrote no traceback (killed from outside) before any."""
            if not bad:
                return None
            caught = [r for r in range(world) if error(r)]
            return min(set(bad) | set(caught), key=lambda r: (error(r) or (-1,))[0])

        deadline = time.monotonic() + timeout
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = first([r for r, p in enumerate(procs) if p.exitcode not in (None, 0)])
                if failed is not None:
                    break
                if time.monotonic() > deadline:
                    failed = "timeout"
                    break
                time.sleep(0.05)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
                if p.is_alive():
                    p.kill()
                    p.join()
        if failed is None:
            failed = first([r for r, p in enumerate(procs) if p.exitcode != 0])
        if failed is not None:
            if failed == "timeout":
                raise TimeoutError(f"{world} ranks of {target.__name__} ran past {timeout} s")
            # every failed rank's traceback, the first rank to fail last (the
            # others mostly report the connection it left): a tail shows it
            codes = [p.exitcode for p in procs]
            texts = []
            for r in sorted(range(world), key=lambda r: r == failed):
                if error(r):
                    texts.append(f"rank {r}:\n" + error(r)[1])
                elif r == failed:
                    texts.append(f"rank {r}: no traceback (exit code {codes[r]}: killed by a "
                                 f"signal, or by the system for memory)")
            head = f"{world} ranks of {target.__name__}, exit codes {codes}"
            raise RuntimeError(f"{head}\n" + "\n".join(texts)
                               + f"\n{head}: rank {failed} failed first")
        return [torch.load(os.path.join(workdir, f"rank{r}.pt"), weights_only=False)
                for r in range(world)]
