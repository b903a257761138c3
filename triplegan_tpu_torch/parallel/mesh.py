"""The data mesh on ``torch.distributed``: the port of
``triplegan_tpu/parallel/mesh.py``.

The JAX package builds a 1-D mesh of the local devices in one process and
wraps the step in ``shard_map``. The port runs PyTorch's way: one process
per card (``torchrun --nproc-per-node N -m triplegan_tpu_torch.cli train
--set 'mesh_shape=(N,)' ...``), each holding the whole state, and the
same decomposition:

* parameters, Adam moments and batch-norm statistics replicated: every
  rank builds (or restores) the same state and applies the same update;
* batches split on axis 0: a rank takes ``batch_size // world`` rows
  (``Mesh.rank_rows`` of a global host batch, or its own draws on the
  device);
* each player's gradients averaged over the ranks before its Adam, one
  flattened ``all_reduce`` per player (``Mesh.pmean_tree``);
* batch-norm moments averaged (sync-BN, ``Mesh.pmean_grad``: the gradient
  of an average is the average of the gradients, so its backward averages
  the cotangents), and the REINFORCE baseline averaged;

so that a step on N ranks computes the single-device update on the
global batch, up to the order of float32 sums. Host-side outputs (logs,
grids, ``config.json``) are the coordinator's (rank 0); checkpoints are
written by the coordinator and read by every rank.

The only collective is ``all_reduce``, which both backends serve: NCCL
for CUDA devices, gloo for the CPU (and for CUDA tensors, which gloo
stages through the host: two ranks can then share one card, which NCCL
refuses). A caller that initialised a process group itself keeps it.
"""

from __future__ import annotations

import dataclasses
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

_TORCHRUN_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def backend_for(device: torch.device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def _torchrun_command(n) -> str:
    return (f"torchrun --nproc-per-node {n} -m triplegan_tpu_torch.cli train --set 'mesh_shape=({n},)' "
            f"... (or set multihost_coordinator, multihost_num_processes and multihost_process_id)")


def _env(name: str) -> str:
    if name not in os.environ:
        raise RuntimeError(f"init_distributed: {name} is not set and no value was given: launch with "
                           f"{_torchrun_command('N')}")
    return os.environ[name]


def init_distributed(device, coordinator: str = "", num_processes: int = 0, process_id: int = -1) -> None:
    """Join the process group of a data-parallel run, with the backend that
    ``device`` takes (``backend_for``). ``coordinator`` ("host:port") is a
    ``tcp://`` rendezvous, ``num_processes`` the world size and
    ``process_id`` this process's rank, each as the ``multihost_*`` config
    fields give it; "", 0 and -1 read torchrun's ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE`` and ``RANK``. A process group that the
    caller initialised is kept as it is."""
    if dist.is_initialized():
        return
    addr = coordinator or f"{_env('MASTER_ADDR')}:{_env('MASTER_PORT')}"
    world = num_processes if num_processes > 0 else int(_env("WORLD_SIZE"))
    rank = process_id if process_id >= 0 else int(_env("RANK"))
    device = torch.device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend_for(device), init_method=f"tcp://{addr}", world_size=world, rank=rank)


def is_coordinator() -> bool:
    """True on the process that owns host-side outputs (logs, grids,
    config.json): rank 0, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


class _PMean(torch.autograd.Function):
    """The mean over the ranks, whose backward is the mean over the ranks
    of the cotangents: JAX's ``lax.pmean`` and its transpose."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.pmean(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.pmean(g.contiguous()), None


def _leaves(tree):
    for v in tree.values():
        yield from _leaves(v) if isinstance(v, dict) else (v,)


def _rebuild(tree, it):
    return {k: _rebuild(v, it) if isinstance(v, dict) else next(it) for k, v in tree.items()}


@dataclasses.dataclass
class Mesh:
    """The ranks of a data-parallel run: the process group, this process's
    rank, the world size, the device this rank computes on and the group's
    backend. ``collectives`` and ``collective_s`` count the all-reduces this
    rank issued and the host seconds they took (with NCCL the enqueue; with
    gloo the whole exchange, which first waits for the kernels that make
    its input)."""

    group: Optional[dist.ProcessGroup]
    rank: int
    world: int
    device: torch.device
    backend: str
    collectives: int = 0
    collective_s: float = 0.0

    @property
    def coordinator(self) -> bool:
        return self.rank == 0

    def _all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self.group)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return t

    def psum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the ranks (a new tensor)."""
        return self._all_reduce(t.detach().clone())

    def pmean(self, t: torch.Tensor) -> torch.Tensor:
        """The mean of ``t`` over the ranks (a new tensor; no gradient)."""
        return self.psum(t) / self.world

    def pmean_grad(self, t: torch.Tensor) -> torch.Tensor:
        """``pmean`` inside autograd: its gradient is the mean of the
        ranks' cotangents, so a loss of the averaged value differentiates
        as the global-batch loss does (sync-BN's moments)."""
        return _PMean.apply(t, self)

    def _tree(self, tree, mean: bool):
        leaves = list(_leaves(tree))
        out: list = [None] * len(leaves)
        by_dtype: Dict[torch.dtype, list] = {}
        for i, t in enumerate(leaves):
            by_dtype.setdefault(t.dtype, []).append(i)
        for idx in by_dtype.values():  # one collective per dtype
            flat = self._all_reduce(torch.cat([leaves[i].detach().reshape(-1) for i in idx]))
            if mean:
                flat = flat / self.world
            parts = torch.split(flat, [leaves[i].numel() for i in idx])
            for i, p in zip(idx, parts):
                out[i] = p.view(leaves[i].shape)
        return _rebuild(tree, iter(out))

    def psum_tree(self, tree):
        """Every tensor of a nested dict summed over the ranks, with one
        flattened all-reduce per dtype."""
        return self._tree(tree, mean=False)

    def pmean_tree(self, tree):
        """Every tensor of a nested dict averaged over the ranks, with one
        flattened all-reduce per dtype (a player's gradients: one)."""
        return self._tree(tree, mean=True)

    def any(self, flag: bool) -> bool:
        """True on every rank if ``flag`` is true on any (an all-reduce of
        the maximum; waits for every rank, so it is also a barrier)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32, device=self.device)
        return bool(self._all_reduce(t, dist.ReduceOp.MAX).item())

    def barrier(self) -> None:
        self.any(False)

    def rows(self, n: int) -> slice:
        """This rank's rows of a global batch of ``n``."""
        if n % self.world:
            raise ValueError(f"a batch of {n} rows does not split evenly over {self.world} ranks")
        b = n // self.world
        return slice(self.rank * b, (self.rank + 1) * b)

    def rank_rows(self, tree):
        """This rank's rows (axis 0) of every array or tensor of a nested
        dict of one global batch, which every rank holds: the counterpart
        of JAX's ``stage_global``."""
        return {k: self.rank_rows(v) if isinstance(v, dict) else v[self.rows(len(v))]
                for k, v in tree.items()}


def make_mesh(n_devices: int, device, group: Optional[dist.ProcessGroup] = None) -> Mesh:
    """The mesh of the initialised process group (default the world),
    which must hold exactly ``n_devices`` ranks: a smaller or larger world
    raises rather than train under a mesh the config does not name."""
    if not dist.is_initialized():
        raise RuntimeError(
            f"make_mesh: a mesh of {n_devices} needs a process group, and none is initialised: "
            f"launch with {_torchrun_command(n_devices)}. Refusing to train unsharded.")
    world = dist.get_world_size(group)
    if world != n_devices:
        raise ValueError(
            f"make_mesh: requested {n_devices} devices but the process group holds {world} ranks: "
            f"refusing to build another mesh (a mesh_shape=({n_devices},) run would otherwise train "
            f"under {world}-way data parallelism while its config claims {n_devices}). Launch "
            f"{n_devices} processes (torchrun --nproc-per-node {n_devices}), or set mesh_shape=({world},).")
    return Mesh(group, dist.get_rank(group), world, torch.device(device), dist.get_backend(group))


def mesh_for(cfg, device) -> Optional[Mesh]:
    """The mesh a config runs on from ``device``: None for ``mesh_shape``
    (1,) without ``multihost`` (one process, no collectives); else the
    process group, joined here from the ``multihost_*`` fields or
    torchrun's environment if the caller has not, and held to
    ``prod(mesh_shape)`` ranks. A mesh of more than one with neither a
    group nor torchrun's environment raises: it never trains unsharded."""
    n = math.prod(cfg.mesh_shape)
    multihost = bool(cfg.get("multihost", False))
    if n == 1 and not multihost:
        return None
    if not dist.is_initialized():
        if not multihost and not all(k in os.environ for k in _TORCHRUN_ENV):
            raise RuntimeError(
                f"mesh_shape={tuple(cfg.mesh_shape)} needs {n} processes, one per card, and this one "
                f"is alone (no process group, no torchrun environment): launch with "
                f"{_torchrun_command(n)}. Refusing to train unsharded.")
        init_distributed(device, str(cfg.get("multihost_coordinator", "")),
                         int(cfg.get("multihost_num_processes", 0)),
                         int(cfg.get("multihost_process_id", -1)))
    return make_mesh(n, device)


# ---------------------------------------------------------------------------
# Local ranks: N processes on one machine, for tests and chip_smoke.py
# ---------------------------------------------------------------------------


def _to_host(obj):
    """Tensors as numpy arrays (bfloat16 widened to float32, exactly), so a
    rank's result crosses the queue by value."""
    if isinstance(obj, torch.Tensor):
        t = obj.detach().cpu()
        return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
    if isinstance(obj, dict):
        return {k: _to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_host(v) for v in obj)
    return obj


def _rank_main(rank, world, device, backend, store_path, fn, args, results):
    try:
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend or backend_for(dev), store=dist.FileStore(store_path, world),
                                rank=rank, world_size=world)
        try:
            out = _to_host(fn(make_mesh(world, dev), *args))
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the parent, which fails the call
        results.put((rank, False, traceback.format_exc()))


def run_local_ranks(fn: Callable, world: int, device="cpu", backend: Optional[str] = None,
                    tmpdir: Optional[str] = None, args: Sequence = (), timeout: float = 900.0) -> list:
    """Run ``fn(mesh, *args)`` in ``world`` new processes (spawned), one
    rank each on ``device``, joined through a ``FileStore`` under
    ``tmpdir`` (no TCP port, so concurrent jobs cannot collide), with
    ``backend`` (default ``backend_for(device)``; gloo puts several ranks
    on one card). ``fn`` must be importable by name. Returns each rank's
    result in rank order, tensors as numpy arrays. A rank that raises, or
    a job past ``timeout`` seconds, fails the call (RuntimeError with the
    rank's traceback) and every rank is stopped."""
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    store = os.path.join(tempfile.mkdtemp(prefix="ranks-", dir=tmpdir), "store")
    procs = [ctx.Process(target=_rank_main, args=(r, world, str(device), backend, store, fn, tuple(args), results))
             for r in range(world)]
    for p in procs:
        p.start()
    got: Dict[int, object] = {}
    deadline = time.monotonic() + timeout
    try:
        while len(got) < world:
            try:
                rank, ok, out = results.get(timeout=max(deadline - time.monotonic(), 0.01))
            except queue.Empty:
                raise RuntimeError(f"run_local_ranks: {world - len(got)} of {world} ranks gave no result "
                                   f"within {timeout} s") from None
            if not ok:
                raise RuntimeError(f"run_local_ranks: rank {rank} of {world} failed:\n{out}")
            got[rank] = out
        for p in procs:
            p.join(timeout=max(deadline - time.monotonic(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    return [got[r] for r in range(world)]


def state_digest(tree) -> str:
    """A sha256 of every tensor of a nested dict, in key order, by its
    bytes: equal digests are bitwise-equal trees."""
    import hashlib

    h = hashlib.sha256()

    def walk(t, prefix=""):
        for k in sorted(t):
            v = t[k]
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                a = v.detach().cpu().contiguous()
                h.update(f"{prefix}{k}:{a.dtype}:{tuple(a.shape)}".encode())
                h.update(a.reshape(-1).view(torch.uint8).numpy().tobytes())

    walk(tree)
    return h.hexdigest()
