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
    It uses the collectives both backends have: ``all_to_all_single`` and the
    list form of ``all_gather``; reductions gather and combine in rank order.

``ranks`` lists the ranks this process holds, and ``run(fn)`` calls
``fn(rank_group)`` for each of them and returns their results in rank order:
all N for a ThreadGroup, this process's own for a TorchDistGroup.
"""
from __future__ import annotations

import threading
from typing import Any, Callable, Sequence

import torch

from .table import resolve_device

__all__ = ["ThreadGroup", "TorchDistGroup", "REDUCE_OPS"]

REDUCE_OPS = ("sum", "min", "max")

# seconds a rank of a ThreadGroup waits at a collective: a rank that never
# reaches it breaks the group instead of hanging it
BARRIER_TIMEOUT_S = 600.0


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


class TorchDistGroup:
    """This process's rank of an initialised ``torch.distributed`` group.

    ``device`` is where this rank's tensors live (default: the current CUDA
    device under NCCL, the CPU otherwise)."""

    def __init__(self, device: str | torch.device | None = None,
                 process_group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("TorchDistGroup: call torch.distributed."
                               "init_process_group first")
        self._dist = dist
        self._pg = process_group
        self.rank = dist.get_rank(process_group)
        self.size = dist.get_world_size(process_group)
        self.ranks = (self.rank,)
        if device is None:
            device = (torch.device("cuda", torch.cuda.current_device())
                      if dist.get_backend(process_group) == "nccl"
                      else torch.device("cpu"))
        self.device = torch.device(device)

    def run(self, fn: Callable[["TorchDistGroup"], Any]) -> list:
        return [fn(self)]

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x, group=self._pg)
        return out

    def all_gather(self, x: torch.Tensor) -> torch.Tensor:
        shape, dtype = x.shape, x.dtype
        # gloo takes no bool and no 0-d tensors
        y = x.reshape(-1).to(torch.uint8 if dtype == torch.bool else dtype)
        outs = [torch.empty_like(y) for _ in range(self.size)]
        self._dist.all_gather(outs, y.contiguous(), group=self._pg)
        return torch.stack(outs).to(dtype).reshape(self.size, *shape)

    def all_reduce(self, x: torch.Tensor, op: str = "sum") -> torch.Tensor:
        return _reduce(list(self.all_gather(x)), op)

    def ppermute(self, x: torch.Tensor, perm: Sequence[tuple[int, int]]
                 ) -> torch.Tensor:
        dist = self._dist
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == d == self.rank:
                out = x.clone()
            elif s == self.rank:
                ops.append(dist.P2POp(dist.isend, x, d, self._pg))
            elif d == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, s, self._pg))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out
