"""A (seeds x kkt) device mesh over a ``torch.distributed`` process group.

Counterpart of ``ttipm_tpu/parallel/mesh.py``, whose mesh is a 2D array of
JAX devices with ``shard_map`` programs over it.  Here a mesh is a world
of processes, one rank a mesh position, laid out as the JAX package lays
out its devices: rank ``r`` sits at (seeds ``r // K``, kkt ``r % K``) of a
mesh of shape ``{"seeds": S, "kkt": K}``.

* ``seeds`` (the data-parallel axis): independent instances are split
  into S contiguous shards, one a seeds row; the ranks of a row hold the
  same instances.  Seeds never communicate except for the batch's stop
  decisions and metrics (an ``all_reduce`` over the ranks of a kkt
  column, ``Mesh.seeds_group``).
* ``kkt`` (the tensor-parallel axis): the dense projected blocks
  ``einsum("lsr,smnS,LSR->lmLrnR")`` (K1) are summed over the operator
  bond ``s``; each rank of a row assembles the partial block of its slice
  of ``s`` and one ``all_reduce(SUM)`` over the row (``Mesh.kkt_group``)
  completes it before the factorization.  Everything else is replicated
  within a row.

The mesh uses two collectives on device tensors, ``all_reduce`` and
``broadcast``: ``gloo`` reduces CUDA tensors for these two only (staging
them through host memory itself), and ranks that share one card must use
``gloo`` (NCCL refuses two ranks on one device).  The backend rule:
``gloo`` for CPU ranks, ``nccl`` by default when each rank has a card of
its own, ``gloo`` when asked for (``backend="gloo"``) and required where
CUDA ranks share a card; ``make_mesh`` raises rather than switch.

``spawn_mesh`` runs a function on every rank of a new world: spawned
processes (CUDA does not survive a fork), the rendezvous through a
``file://`` store in a temporary directory, the kernels built once in
the parent before the ranks start.  A rank that fails fails the call.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ttipm_tpu_torch.ops import kernels
from ttipm_tpu_torch.ops.linalg import qr_solve

__all__ = ["Mesh", "make_mesh", "spawn_mesh", "rank_devices", "choose_backend",
           "sharded_newton_micro", "batched_solve_metrics"]

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


def rank_devices(n: int, device: str) -> List[str]:
    """The device of each of ``n`` ranks: ``"cpu"``; ``"cuda:i"`` (every
    rank on card i); or ``"cuda"``, rank r on card ``r % count``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return ["cpu"] * n
    if dev.type != "cuda":
        raise ValueError(f"device {device!r}: cpu, cuda or cuda:<index>")
    if dev.index is not None:
        return [f"cuda:{dev.index}"] * n
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("device cuda: no CUDA device")
    return [f"cuda:{r % count}" for r in range(n)]


def choose_backend(devices: Sequence[str], backend=None) -> str:
    """The process group backend for ranks on ``devices`` (one a rank).
    Raises ``ValueError`` for ``nccl`` on CPU ranks, and for CUDA ranks
    that share a card without ``backend="gloo"``."""
    cuda = [d for d in devices if d != "cpu"]
    if cuda and len(cuda) != len(devices):
        raise ValueError(f"ranks on CPU and CUDA devices at once: {list(devices)}")
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: gloo or nccl")
    if not cuda:
        if backend == "nccl":
            raise ValueError("nccl needs CUDA ranks; CPU ranks use gloo")
        return "gloo"
    shared = len(set(cuda)) < len(cuda)
    if shared and backend != "gloo":
        raise ValueError(f"{len(cuda)} CUDA ranks share {len(set(cuda))} card(s): NCCL refuses "
                         "two ranks on one device; pass backend='gloo' to share a card")
    return backend or "nccl"


@dataclass
class CollectiveStats:
    """Collectives a rank made, by kind, and the bytes of their tensors."""
    all_reduce: int = 0
    broadcast: int = 0
    bytes: int = 0

    def as_dict(self) -> dict:
        return {"all_reduce": self.all_reduce, "broadcast": self.broadcast,
                "bytes": self.bytes}


@dataclass
class Mesh:
    """This rank's view of a (seeds x kkt) mesh: the shape, its
    coordinates, the process groups of its seeds row (``kkt_group``, the
    ranks that share its instances) and of its kkt column
    (``seeds_group``), its device and the backend."""
    shape: dict
    rank: int
    coords: tuple
    device: torch.device
    backend: str
    kkt_group: object
    seeds_group: object
    stats: CollectiveStats = field(default_factory=CollectiveStats)

    @property
    def seeds(self) -> int:
        return self.shape["seeds"]

    @property
    def kkt(self) -> int:
        return self.shape["kkt"]

    def _group(self, axis: str):
        return {"kkt": self.kkt_group, "seeds": self.seeds_group, "world": None}[axis]

    def all_reduce(self, t: torch.Tensor, op: str = "sum", axis: str = "kkt") -> torch.Tensor:
        """Reduce ``t`` in place over the ranks of ``axis`` ("kkt": this
        rank's seeds row; "seeds": its kkt column; "world"); returns it."""
        if (self.kkt if axis == "kkt" else self.seeds if axis == "seeds"
                else self.seeds * self.kkt) > 1:
            dist.all_reduce(t, op=_OPS[op], group=self._group(axis))
            self.stats.all_reduce += 1
            self.stats.bytes += t.numel() * t.element_size()
        return t

    def reduce_values(self, values, op: str, axis: str = "seeds") -> np.ndarray:
        """Host floats reduced over ``axis`` (gloo: a CPU tensor; nccl: one
        on this rank's card)."""
        dev = "cpu" if self.backend == "gloo" else self.device
        t = torch.tensor(np.asarray(values, dtype=np.float64), device=dev)
        return self.all_reduce(t, op, axis).cpu().numpy()

    def any(self, flag: bool, axis: str = "seeds") -> bool:
        """True where ``flag`` is true on any rank of ``axis``."""
        return bool(self.reduce_values([float(flag)], "max", axis)[0] > 0)

    def broadcast(self, t: torch.Tensor, src: int) -> torch.Tensor:
        """``t`` of global rank ``src`` to every rank, in place."""
        dist.broadcast(t, src=src)
        self.stats.broadcast += 1
        self.stats.bytes += t.numel() * t.element_size()
        return t

    def seeds_shard(self, n: int) -> slice:
        """This row's contiguous shard of ``n`` instances (S divides n)."""
        if n % self.seeds:
            raise ValueError(f"{n} instances do not split over {self.seeds} seeds rows")
        per = n // self.seeds
        return slice(self.coords[0] * per, (self.coords[0] + 1) * per)

    def s_range(self, s: int) -> tuple:
        """This rank's contiguous slice [lo, hi) of an operator bond of
        size ``s`` over the kkt axis (empty on some ranks where s < K)."""
        k, K = self.coords[1], self.kkt
        return k * s // K, (k + 1) * s // K

    def partial_schur(self, blocks, assemble):
        """K1 over this rank's slice of the operator bond ``s`` of every block
        (``phi_l[..., s, :]``, ``A[s, ...]`` as strided views), summed over
        the kkt row by one ``all_reduce``.  ``blocks`` are ``(phi_l, A,
        phi_r)`` with a leading batch axis; ``assemble`` maps such blocks to a
        list of (B, M, N) blocks.  A block whose slice is empty on this rank
        adds zeros.  With kkt = 1: ``assemble(blocks)``."""
        if self.kkt == 1:
            return list(assemble(blocks))
        parts = []
        for pl, a, pr in blocks:
            lo, hi = self.s_range(a.shape[1])
            parts.append((pl[:, :, lo:hi], a[:, lo:hi], pr) if hi > lo else None)
        live = [p for p in parts if p is not None]
        got = iter(assemble(live) if live else [])
        pl, a, pr = blocks[0]
        size = (pl.shape[0], pl.shape[1] * a.shape[2] * pr.shape[1],
                pl.shape[3] * a.shape[3] * pr.shape[3])
        out = torch.stack([next(got) if p is not None else pl.new_zeros(size) for p in parts])
        self.all_reduce(out, "sum", "kkt")
        return list(out.unbind(0))

    def gather_rows(self, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Every row's shard of tensors with a leading instance axis, of
        the same shapes and types on every rank, concatenated in row order
        on every rank: one ``broadcast`` a row, from its kkt-rank 0, of the
        tensors packed into one f64 buffer (f32 values are exact in it)."""
        if self.seeds == 1:
            return list(tensors)
        flat = torch.cat([t.reshape(-1).to(torch.float64) for t in tensors])
        rows = []
        for i in range(self.seeds):
            buf = flat if i == self.coords[0] else torch.empty_like(flat)
            rows.append(self.broadcast(buf, src=i * self.kkt))
        out, off = [], 0
        for t in tensors:
            parts = [r[off:off + t.numel()].reshape(t.shape) for r in rows]
            out.append(torch.cat(parts).to(t.dtype))
            off += t.numel()
        return out


def make_mesh(n_devices: int, kkt: int = 2, *, device: str, backend=None) -> Mesh:
    """This rank's mesh of shape (n_devices / kkt, kkt) over the world
    process group, kkt lowered until it divides ``n_devices`` (the JAX
    rule).  The device and backend rule is checked first (it raises
    without a process group); then the world must be initialized with
    ``n_devices`` ranks.  Every rank calls it (it makes the sub-groups)."""
    devices = rank_devices(n_devices, device)
    backend = choose_backend(devices, backend)
    while n_devices % kkt != 0:
        kkt -= 1
    if not dist.is_initialized() or dist.get_world_size() != n_devices:
        raise RuntimeError(f"make_mesh({n_devices}): needs an initialized world of "
                           f"{n_devices} ranks (spawn_mesh starts one)")
    if dist.get_backend() != backend:
        raise ValueError(f"the world runs {dist.get_backend()}, the mesh needs {backend}")
    S = n_devices // kkt
    rank = dist.get_rank()
    rows = [dist.new_group([i * kkt + k for k in range(kkt)]) for i in range(S)]
    cols = [dist.new_group([i * kkt + k for i in range(S)]) for k in range(kkt)]
    dev = torch.device(devices[rank])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    return Mesh(shape={"seeds": S, "kkt": kkt}, rank=rank, coords=(rank // kkt, rank % kkt),
                device=dev, backend=backend, kkt_group=rows[rank // kkt],
                seeds_group=cols[rank % kkt])


# ---------------------------------------------------------------------------
# Launcher
# ---------------------------------------------------------------------------

def _rank_main(rank, n, kkt, device, backend, work, threads, timeout_s, fn, args):
    try:
        torch.set_num_threads(threads)
        dist.init_process_group(backend, init_method=f"file://{work}/store", rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=timeout_s))
        mesh = make_mesh(n, kkt, device=device, backend=backend)
        out = fn(mesh, *args)
        path = os.path.join(work, f"rank{rank}.pt")
        torch.save(out, path + ".tmp")
        os.replace(path + ".tmp", path)
    except BaseException:
        with open(os.path.join(work, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def spawn_mesh(fn, n: int, kkt: int, device: str, backend=None, args=(),
               timeout_s: float = 900.0) -> list:
    """``fn(mesh, *args)`` on each of ``n`` spawned ranks of a (n / kkt,
    kkt) mesh on ``device`` (see ``rank_devices``); returns the ranks'
    results in rank order (``fn`` must be importable, and return host
    data).  A rank that raises, dies or outlives ``timeout_s`` makes the
    call raise ``RuntimeError`` with its traceback; the other ranks are
    then stopped."""
    backend = choose_backend(rank_devices(n, device), backend)
    if device != "cpu":
        from ttipm_tpu_torch.ops import _build

        _build.build_library()  # once here, not once a rank
    threads = max(1, (os.cpu_count() or 1) // n)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="ttipm_mesh_") as work:
        procs = [ctx.Process(target=_rank_main,
                             args=(r, n, kkt, device, backend, work, threads, timeout_s, fn,
                                   tuple(args)))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                failed = next((r for r, p in enumerate(procs)
                               if p.exitcode not in (None, 0)), None)
                if failed is not None or time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            if failed is None:
                failed = next((r for r, p in enumerate(procs) if p.exitcode != 0), None)
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(10)
        if failed is not None:
            err = os.path.join(work, f"rank{failed}.err")
            why = open(err).read() if os.path.exists(err) else (
                f"exit code {procs[failed].exitcode}" if procs[failed].exitcode is not None
                else f"still running after {timeout_s} s")
            raise RuntimeError(f"mesh rank {failed} of {n} failed:\n{why}")
        return [torch.load(os.path.join(work, f"rank{r}.pt"), weights_only=False)
                for r in range(n)]


# ---------------------------------------------------------------------------
# The two functions of the JAX module
# ---------------------------------------------------------------------------

def sharded_newton_micro(mesh: Mesh):
    """The batched Newton micro-step over the mesh
    (``ttipm_tpu/parallel/mesh.py:48-91``): for each instance of this
    row's seeds shard, the projected operator from this rank's slice of
    the operator bond by K1 (the seeds shard as K1's batch), one
    ``all_reduce(SUM)`` over the kkt row, ``+ 1e-10 I``, ``qr_solve`` and
    the residual norm; the mean residual over all seeds by an
    ``all_reduce`` over the seeds column.  The step takes the global
    arrays (phi_l (b, r, s, r), A (b, s, n, n, S), phi_r (b, R, S, R),
    rhs (b, r, n, R); S divides b) and returns every seed's solution on
    every rank and the mean residual."""

    def step(phi_l, A_core, phi_r, rhs):
        rows = mesh.seeds_shard(rhs.shape[0])
        blocks = [(phi_l[rows], A_core[rows], phi_r[rows])]
        B = mesh.partial_schur(blocks, lambda bl: list(kernels.schur_assemble_batch(bl)))[0]
        m = B.shape[-1]
        B = B + 1e-10 * torch.eye(m, dtype=B.dtype, device=B.device)
        rb = rhs[rows].reshape(-1, m, 1)
        x = qr_solve(B, rb)
        res = torch.linalg.vector_norm((B @ x - rb)[..., 0], dim=1)
        mean = mesh.all_reduce(res.mean().reshape(1), "sum", "seeds") / mesh.seeds
        (xs,) = mesh.gather_rows([x.reshape(rhs[rows].shape)])
        return xs, mean[0]

    return step


def batched_solve_metrics(mesh: Mesh, feas_errors: torch.Tensor) -> torch.Tensor:
    """The mean of a per-seed metric over all seeds
    (``ttipm_tpu/parallel/mesh.py:94-103``): this row's shard's mean,
    averaged over the seeds column by one ``all_reduce``."""
    local = feas_errors[mesh.seeds_shard(feas_errors.shape[0])].mean().reshape(1)
    return (mesh.all_reduce(local, "sum", "seeds") / mesh.seeds)[0]
