"""Rank groups: the collectives the distributed engine runs on.

The reference package runs one SPMD program under ``shard_map`` and names a
mesh axis for its collectives.  The port runs one Python call per rank and
hands each a *rank group*, which knows its ``rank`` and ``size`` and offers
the collectives the exchange operators use:

  * ``all_to_all(x)``     x is (size, ...): block j goes to rank j; returns
                          (size, ...) where block j came from rank j;
  * ``all_gather(x)``     returns (size, *x.shape), rank order;
  * ``all_reduce(x, op)`` op in sum / min / max, combined in rank order, so
                          a float sum has the same bits on every group;
  * ``ppermute(x, perm)`` perm = [(src, dst), ...]; returns what this rank
                          received, zeros if nothing.

Two implementations:

  * :class:`ThreadGroup` — N ranks as threads of one process on one device.
    A collective puts each rank's tensor in a shared slot, waits at a
    barrier, copies its part out of the others' tensors on the device, and
    waits again before the slot is reused.  Every rank enqueues on the
    stream that was current where :meth:`ThreadGroup.run` was called, so a
    copy enqueued after the barrier runs after its producer.  An exception
    in any rank aborts the barrier, and ``run`` re-raises it.
  * :class:`TorchDistGroup` — one rank per process over an initialised
    ``torch.distributed`` process group (NCCL on the card, gloo on the CPU).
    It uses the collectives both backends have: ``all_to_all_single``, the
    list form of ``all_gather`` and ``batch_isend_irecv``; reductions gather
    and combine in rank order.  :func:`world_group` joins the world a
    launcher (``torchrun``) started, one process per card;
    :meth:`TorchDistGroup.shrink` makes the group of the survivors of a
    device loss.  Several processes on one card run over gloo (NCCL refuses
    two ranks on one device); gloo has no CUDA path for some collectives,
    and those it stages through the host (:attr:`TorchDistGroup.staged`).

``ranks`` lists the ranks this process holds, and ``run(fn)`` calls
``fn(rank_group)`` for each of them and returns their results in rank order:
all N for a ThreadGroup, this process's own for a TorchDistGroup.
"""
from __future__ import annotations

import datetime
import os
import threading
from typing import Any, Callable, Sequence

import torch

from .table import resolve_device

__all__ = ["ThreadGroup", "TorchDistGroup", "REDUCE_OPS", "join_world",
           "world_group", "WORLD_TIMEOUT_S", "GLOO_CUDA_STAGED"]

REDUCE_OPS = ("sum", "min", "max")

# seconds a rank of a ThreadGroup waits at a collective: a rank that never
# reaches it breaks the group instead of hanging it
BARRIER_TIMEOUT_S = 600.0
# seconds a process of a TorchDistGroup waits at a collective: a process
# that raised alone breaks the others' collectives instead of hanging them
WORLD_TIMEOUT_S = 300.0
# the collectives gloo cannot run on CUDA tensors: under torch 2.11 on an
# H100 its send and receive (``batch_isend_irecv``) wrote from the device
# pointer and aborted the process ("writev: Bad address"), where its
# all_to_all_single, all_gather and all_reduce ran.  Under gloo on a card
# these go through the host.
GLOO_CUDA_STAGED = frozenset({"ppermute"})


def _reduce(xs: Sequence[torch.Tensor], op: str) -> torch.Tensor:
    """Combine the ranks' tensors in rank order."""
    if op not in REDUCE_OPS:
        raise ValueError(f"unknown reduction {op!r}; expected one of "
                         f"{REDUCE_OPS}")
    acc = xs[0].clone()
    for x in xs[1:]:
        if op == "sum":
            acc = acc + x
        elif op == "min":
            acc = torch.minimum(acc, x)
        else:
            acc = torch.maximum(acc, x)
    return acc


class ThreadGroup:
    """``n`` ranks as threads of one process, all on ``device`` (``cuda``
    unless the caller names another; raises where CUDA is absent)."""

    def __init__(self, n: int, device: str | torch.device | None = None):
        if n < 1:
            raise ValueError(f"ThreadGroup needs at least one rank, got {n}")
        self.size = n
        self.ranks = range(n)
        self.device = resolve_device(device)

    def run(self, fn: Callable[["_ThreadRank"], Any]) -> list:
        """``fn(rank)`` on every rank, each on its own thread; the results in
        rank order.  The first error of any rank is re-raised here."""
        # a fresh barrier per run: an error in the last run broke the old one
        self._barrier = threading.Barrier(self.size)
        self._slots: list[Any] = [None] * self.size
        results: list[Any] = [None] * self.size
        errors: list[BaseException | None] = [None] * self.size
        stream = torch.cuda.current_stream(self.device) \
            if self.device.type == "cuda" else None

        def body(r: int) -> None:
            try:
                if stream is not None:
                    with torch.cuda.device(self.device), \
                            torch.cuda.stream(stream):
                        results[r] = fn(_ThreadRank(self, r))
                else:
                    results[r] = fn(_ThreadRank(self, r))
            except BaseException as e:   # noqa: BLE001 — re-raised by run()
                errors[r] = e
                self._barrier.abort()

        threads = [threading.Thread(target=body, args=(r,), daemon=True,
                                    name=f"rank-{r}")
                   for r in range(self.size)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._slots = [None] * self.size     # drop the last tensors
        raised = [e for e in errors if e is not None]
        # An error's traceback holds its rank's frames, and with them the
        # rank's tables; neither those frames nor this one may hold the
        # error in turn, or the tables outlive it until a garbage
        # collection (a device loss would keep the dead width's shards).
        errors.clear()
        if not raised:
            return results
        try:
            # the rank that failed first, not the ranks its abort woke up
            first = next((e for e in raised
                          if not isinstance(e, threading.BrokenBarrierError)),
                         raised[0])
            if isinstance(first, threading.BrokenBarrierError):
                raise TimeoutError(f"ThreadGroup: a rank waited more than "
                                   f"{BARRIER_TIMEOUT_S} s at a collective") \
                    from first
            raise first
        finally:
            del raised, first

    # -- used by the ranks ---------------------------------------------------
    def _share(self, rank: int, x) -> list:
        """Deposit ``x``, wait for every rank's, return them all."""
        self._slots[rank] = x
        self._barrier.wait(BARRIER_TIMEOUT_S)
        return list(self._slots)

    def _release(self) -> None:
        """Wait until every rank has enqueued its reads of the slots."""
        self._barrier.wait(BARRIER_TIMEOUT_S)


class _ThreadRank:
    """One rank's view of a :class:`ThreadGroup`."""

    def __init__(self, group: ThreadGroup, rank: int):
        self.group = group
        self.rank = rank
        self.size = group.size
        self.device = group.device

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.group._share(self.rank, x)
        out = torch.stack([xs[j][self.rank] for j in range(self.size)])
        self.group._release()
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        xs = self.group._share(self.rank, x)
        out = torch.stack(xs)
        self.group._release()
        return out

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        xs = self.group._share(self.rank, x)
        out = _reduce(xs, op)
        self.group._release()
        return out

    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]
                 ) -> torch.Tensor:
        xs = self.group._share(self.rank, x)
        src = [s for s, d in perm if d == self.rank]
        out = xs[src[0]].clone() if src else torch.zeros_like(x)
        self.group._release()
        return out


def join_world(device: str | torch.device | None = None,
               backend: str | None = None, init_method: str | None = None,
               timeout_s: float = WORLD_TIMEOUT_S, bind: bool = True
               ) -> tuple[torch.device, bool]:
    """Join the world a launcher started: one process per card.

    ``torchrun`` sets ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` and the
    rendezvous (``env://``); ``init_method`` names another (``file://...``)
    for the same variables.  Without ``WORLD_SIZE`` the world is this one
    process (a ``HashStore``).  A CUDA ``device`` without an index becomes
    ``cuda:LOCAL_RANK``, made current.  ``backend`` defaults to NCCL on a
    card and gloo on the CPU; gloo on a card runs several ranks on one
    device.  ``bind`` binds NCCL to the card (``device_id``: the
    communicator starts at once, and torch then makes every subgroup by
    splitting it, which every rank of the world must join).  Every
    collective of the world waits at most ``timeout_s``.  A world that
    exists already is joined as it is.

    Returns this process's device and whether this call made the world (its
    maker destroys it)."""
    import torch.distributed as dist
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", "0")))
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev, False
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    kw = dict(backend=backend,
              timeout=datetime.timedelta(seconds=timeout_s))
    if backend == "nccl" and bind:
        kw["device_id"] = dev
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(init_method=init_method or "env://",
                                rank=int(os.environ["RANK"]),
                                world_size=int(os.environ["WORLD_SIZE"]),
                                **kw)
    else:
        dist.init_process_group(store=dist.HashStore(), rank=0,
                                world_size=1, **kw)
    return dev, True


def world_group(device: str | torch.device | None = None,
                backend: str | None = None, init_method: str | None = None,
                timeout_s: float = WORLD_TIMEOUT_S) -> "TorchDistGroup":
    """This process's rank of the launched world (:func:`join_world`) as a
    :class:`TorchDistGroup`; its :meth:`~TorchDistGroup.close` destroys the
    world where this call made it.  NCCL is not bound to the card: the
    survivors of a device loss make their group without the lost ranks
    (:meth:`TorchDistGroup.shrink`), which a split of the world cannot."""
    dev, made = join_world(device, backend, init_method, timeout_s,
                           bind=False)
    group = TorchDistGroup(dev, timeout_s=timeout_s)
    group.owns_world = made
    return group


# survivors' process groups, one per (world, global ranks): the same
# survivors of a later loss reuse the group the first one made
_SURVIVOR_GROUPS: dict[tuple, object] = {}


def _survivors_group(ranks: tuple[int, ...], backend: str,
                     timeout_s: float):
    """A process group over the world ranks ``ranks`` that only they make.

    ``dist.new_group(ranks, use_local_synchronization=True)`` would too, but
    it names the group after the ranks and the number of groups the calling
    process holds, and meets the members in the world's store under that
    name: where a process lost in one query rejoins the next, it holds
    fewer groups than the survivors of its loss, their names for a later
    group differ, and they wait for each other until the timeout.  This
    group is named after its ranks alone (made once per world:
    ``_SURVIVOR_GROUPS``) and registered as ``new_group`` registers its
    own."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    pg, _ = c10d._new_process_group_helper(
        len(ranks), ranks.index(dist.get_rank()), list(ranks), backend,
        c10d._get_default_store(), "survivors_" + "_".join(map(str, ranks)),
        timeout=datetime.timedelta(seconds=timeout_s))
    c10d._world.pg_group_ranks[pg] = {g: r for r, g in enumerate(ranks)}
    return pg


class TorchDistGroup:
    """This process's rank of an initialised ``torch.distributed`` group.

    ``device`` is where this rank's tensors live (default: the current CUDA
    device under NCCL, the CPU otherwise).  ``process_group`` defaults to
    the world.  ``global_ranks[r]`` is the world rank of group rank ``r``.
    ``staged`` names the collectives that go through the host: under gloo
    on a card, :data:`GLOO_CUDA_STAGED`; else none."""

    owns_world = False

    def __init__(self, device: str | torch.device | None = None,
                 process_group=None, timeout_s: float = WORLD_TIMEOUT_S):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("TorchDistGroup: call torch.distributed."
                               "init_process_group first")
        self._dist = dist
        self._pg = process_group
        self.rank = dist.get_rank(process_group)
        self.size = dist.get_world_size(process_group)
        self.ranks = (self.rank,)
        self.global_ranks = tuple(range(self.size)) if process_group is None \
            else tuple(dist.get_global_rank(process_group, r)
                       for r in range(self.size))
        self.backend = dist.get_backend(process_group)
        self.timeout_s = timeout_s
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if self.backend == "nccl" else torch.device("cpu"))
        self.device = torch.device(device)
        self.staged = GLOO_CUDA_STAGED if (
            self.backend == "gloo" and self.device.type == "cuda") \
            else frozenset()

    def run(self, fn: Callable[["TorchDistGroup"], Any]) -> list:
        return [fn(self)]

    def close(self) -> None:
        """Destroy the world if :func:`world_group` made it."""
        if self.owns_world and self._dist.is_initialized():
            world = self._dist.group.WORLD
            for key in [k for k in _SURVIVOR_GROUPS if k[0] is world]:
                del _SURVIVOR_GROUPS[key]
            self._dist.destroy_process_group()
        self.owns_world = False

    def shrink(self, lost) -> "TorchDistGroup":
        """The group of every rank but the ``lost`` ones (ranks of this
        group), renumbered in the survivors' order, each process on its own
        device.  Only the survivors call it, and the lost processes take no
        part in making the new process group."""
        lost = set(lost)
        if self.rank in lost:
            raise ValueError(f"TorchDistGroup.shrink: rank {self.rank} is "
                             f"among the lost {sorted(lost)}")
        survivors = tuple(g for r, g in enumerate(self.global_ranks)
                          if r not in lost)
        key = (self._dist.group.WORLD, survivors)
        if key not in _SURVIVOR_GROUPS:
            _SURVIVOR_GROUPS[key] = _survivors_group(
                survivors, self.backend, self.timeout_s)
        return TorchDistGroup(self.device, _SURVIVOR_GROUPS[key],
                              self.timeout_s)

    def _out(self, name: str, x: torch.Tensor) -> torch.Tensor:
        """``x`` where the collective ``name`` runs: the host if staged."""
        return x.cpu() if name in self.staged else x

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        y = self._out("all_to_all", x.contiguous())
        out = torch.empty_like(y)
        self._dist.all_to_all_single(out, y, group=self._pg)
        return out.to(self.device)

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        shape, dtype = x.shape, x.dtype
        # gloo takes no bool and no 0-d tensors
        y = self._out("all_gather", x.reshape(-1).to(
            torch.uint8 if dtype == torch.bool else dtype).contiguous())
        outs = [torch.empty_like(y) for _ in range(self.size)]
        self._dist.all_gather(outs, y, group=self._pg)
        return torch.stack(outs).to(self.device).to(dtype) \
            .reshape(self.size, *shape)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _reduce(list(self.all_gather(x)), op)

    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]
                 ) -> torch.Tensor:
        dist = self._dist
        y = self._out("ppermute", x.contiguous())
        out = torch.zeros_like(y)
        ops = []
        # P2POp takes the peer's world rank
        for s, d in perm:
            if s == d == self.rank:
                out = y.clone()
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, y, self.global_ranks[d],
                                      self._pg))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, self.global_ranks[s],
                                      self._pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out.to(self.device)
