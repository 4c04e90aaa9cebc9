"""LM dry-run: every (arch x shape x mesh) cell on a fake group of 256 or
512 ranks, on the ``meta`` device, with the production shardings.

The counterpart of ``repro.launch.dryrun``.  The reference lowers and
compiles each cell's jitted train step, prefill or decode against 512 fake
CPU devices and reads memory, FLOPs, traffic and collectives from XLA.
PyTorch has no compiler to ask, so here the cell runs eagerly: the
process starts a ``fake`` process group of 256 (16x16) or 512 (2x16x16)
ranks before anything else and is rank 0 of it, the model is built on
``meta`` (no values) with DTensor parameters placed by
``distributed/shardings.py``, the inputs (``configs.input_specs``) and
caches are sharded likewise, and the cell's step runs under
:class:`OpCounter`, which sees the local operations DTensor issues on
rank 0's shards and the collectives it issues between them.

Per cell, per device (rank 0, whose shard is the largest where a dim does
not divide, as XLA pads every shard to the largest):

* ``memory.argument_bytes`` / ``output_bytes``: the local bytes of the
  parameters, the optimizer state and the inputs / of what the step
  returns (train: parameters, state and metrics, updated in place; prefill
  and decode: the logits and the cache); ``uneven_leaves`` names the
  leaves with a dim that does not divide; ``temp_bytes`` is null:
  ``torch.distributed._tools.mem_tracker.MemTracker`` reads a peak on
  meta DTensors only where the parameters require grad (a forward alone
  fails to hook them), and the traces run short configs, whose peak is
  not the cell's;
* ``flops``: the local matmul FLOPs (attention included: it is einsums
  here), by ``torch.utils.flop_counter``'s formulas on the local shapes;
* ``traffic_bytes``: each local operation's input and output bytes,
  unfused (views, allocations and zero fills excluded): an upper bound on
  what a fused program moves;
* ``collective_count`` / ``collective_bytes`` by the reference's kind names,
  the bytes of each functional collective's result, as the reference
  counts an HLO collective's result; DTensor's move of a shard from one
  dim to another counts as the one all-to-all a CUDA mesh issues (on this
  CPU mesh DTensor would fall back to an all-gather and a chunk);
* ``shard_moves``: those moves' bytes apart, ``all-to-all`` as counted in
  ``collective_bytes`` and ``as_all_gather`` as the CPU mesh's all-gather
  would count them (its result, every rank's input), so that the bytes
  can be read under either count;
* ``roofline``: ``distributed/roofline.py`` at ``core/perfmodel.CLUSTERS
  ["h100_ib"]``'s peaks (989 TFLOP/s bf16, 3.35 TB/s), the collectives at
  the per-device share of the machine's network (400 GB/s over 8 cards;
  every mesh axis spans machines).  The model's arithmetic, never a
  measurement;
* ``not_reported``: the reference's keys with no counterpart here.

Long loops are not traced step by step.  A run of identical layers (80
in Qwen1.5-110B): the counts are affine in each layer kind's count and in
the hybrid's shared-block applications, so a cell is traced at one or two
layers of each kind and the traces are combined with the exact rational
weights that extrapolate them to the cell's depth (:func:`plan`).  An
SSM's time loop (32768 steps in prefill_32k) runs through
``models/ssm.scan``, which the counter replaces while it counts: its
first, second and last two steps are traced, the second weighted by the
n - 3 it stands for, forward and backward (through the autograd nodes the
weighted step made), as the reference's loop-aware HLO analysis multiplies
a scan body by its trip count.  The memory is read from the cell's
full-size model and inputs, not from a trace.  On the reduced configs the
counts equal a direct trace of every layer and step exactly
(``tests/test_torch_dryrun.py``).

  python -m repro_torch.launch.dryrun --all        # every cell, resumable
  python -m repro_torch.launch.dryrun --arch qwen1_5_110b --shape train_4k \\
      --multi-pod

Records go to ``results/torch/dryrun/<arch>__<shape>__<mesh>[_tag].json``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import time
import traceback
from collections import Counter
from fractions import Fraction

import torch
import torch.distributed as dist
from torch.distributed.distributed_c10d import _resolve_process_group
from torch.distributed.tensor import DTensor, Shard
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from repro_torch.configs import (ARCH_IDS, SHAPES, cell_enabled, get_config,
                                 input_specs)
from repro_torch.core.perfmodel import CLUSTERS
from repro_torch.distributed import shardings as sh
from repro_torch.distributed.roofline import roofline_terms
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import ssm
from repro_torch.models.common import ArchConfig
from repro_torch.models.transformer import Model, segments
from repro_torch.train import optimizer as optim
from repro_torch.train.trainstep import init_train_state, make_train_step

RESULTS = os.path.join(os.path.dirname(__file__), "..", "..", "..",
                       "results", "torch", "dryrun")
CLUSTER = "h100_ib"
NOT_REPORTED = ["compile_s", "generated_code_bytes", "cost_analysis_flops",
                "cost_analysis_bytes", "op_histogram", "hlo_len"]
LOOP_METHOD = ("traces at one or two layers of each kind, extrapolated "
               "exactly to the cell's depth (affine in the layer counts); "
               "each SSM time loop's first, second and last two steps "
               "traced, the second weighted by the n - 3 it stands for, "
               "forward and backward")
_COLLECTIVES = {"all_reduce": "all-reduce", "all_reduce_coalesced":
                "all-reduce", "all_gather_into_tensor": "all-gather",
                "all_gather_into_tensor_coalesced": "all-gather",
                "reduce_scatter_tensor": "reduce-scatter",
                "reduce_scatter_tensor_coalesced": "reduce-scatter",
                "all_to_all_single": "all-to-all",
                "shard_dim_alltoall": "all-to-all"}
# local operations counted as moving no bytes: allocation, aliasing and
# zero fills (the backward of a time loop's ``stack`` fills the slices a
# weighted trace stood in for with zeros, where a direct trace has
# gradients)
_NO_TRAFFIC = {"empty", "empty_strided", "empty_like", "new_empty",
               "new_empty_strided", "detach", "alias", "_unsafe_view",
               "lift_fresh", "set_", "zeros", "zeros_like", "new_zeros",
               "zero_"}


@dataclasses.dataclass(frozen=True)
class Options:
    """The dry-run's switches, as the reference's flags of those names."""
    remat: str = "full"
    constrain: bool = True
    seq_parallel: bool = False
    grad_compress: str = "none"
    microbatches: int = 1
    serve_sharding: bool = False


def model_flops(cfg, shape_id: str, batch: int, seq: int) -> float:
    n = cfg.active_param_count or cfg.param_count
    kind = SHAPES[shape_id][2]
    if kind == "train":
        return 6.0 * n * batch * seq
    if kind == "prefill":
        return 2.0 * n * batch * seq
    return 2.0 * n * batch          # decode: one token


def start_fake_group(world: int) -> None:
    """Make this process rank 0 of a ``fake`` group of ``world`` ranks (its
    collectives return at once and move nothing), replacing any group of
    another size."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == world:
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def _nbytes(t: torch.Tensor) -> int:
    if isinstance(t, DTensor):
        t = t.to_local()
    return t.numel() * t.element_size()


def _is_fake(t) -> bool:
    from torch._subclasses.fake_tensor import FakeTensor
    return isinstance(t, FakeTensor)


class OpCounter(TorchDispatchMode):
    """Counts the local operations under it, in :attr:`counts`: ``flops``,
    ``traffic_bytes`` and each collective kind's count and bytes, each weighted by the trips of the time loop it runs in
    (:meth:`scan`).

    A DTensor operation is passed on (``NotImplemented``), so DTensor
    dispatches it and the local operations it issues on this rank's shards
    come back through the mode; DTensor's own shape propagation (fake
    tensors) and planning (:func:`counting`) are not counted.  A weighted
    step tags the autograd nodes it made; in the backward an operation
    takes the weight of the node running it (and, while a checkpointed
    layer recomputes, of the steps it re-enters)."""

    def __init__(self):
        super().__init__()
        self.counts: Counter = Counter()
        self.paused = False
        self._weights = [1]
        self._node_weight: dict[int, int] = {}

    # -- the time loops ------------------------------------------------------
    def scan(self, step, carry, n: int):
        """``models/ssm.scan`` while counting: the first, the second
        standing for the n - 3 after it, and the last two steps.  The
        middle steps are alike to the operation: each takes its carry from
        the one before and hands its output to the one after, and in the
        backward the gradient a middle step adds to a tensor the loop
        shares (its slice of the time-major inputs) is never the first to
        arrive there (the last two come first), so each of its additions
        is counted.  The skipped steps' outputs are the weighted one's,
        detached."""
        trips = [(i, 1) for i in range(n)] if n <= 4 else \
            [(0, 1), (1, n - 3), (n - 2, 1), (n - 1, 1)]
        ys = []
        for i, w in trips:
            start = self._sequence_nr()
            self._weights.append(self._weights[-1] * w)
            try:
                carry, y = step(i, carry)
            finally:
                self._weights.pop()
            if w != 1:
                self._tag([carry, y], start, w)
            ys += [y] + [y.detach()] * (w - 1)
        return carry, ys

    def _sequence_nr(self) -> int:
        """The autograd sequence number the next node will take."""
        self.paused = True
        try:
            with torch.enable_grad():
                probe = torch.zeros((), requires_grad=True) * 1
            return probe.grad_fn._sequence_nr() + 1
        finally:
            self.paused = False

    def _tag(self, outputs, start: int, weight: int) -> None:
        """Multiply the weight of every autograd node made since ``start``
        and reachable from ``outputs``."""
        frontier = [t.grad_fn for t in tree_leaves(outputs)
                    if isinstance(t, torch.Tensor) and t.grad_fn is not None]
        seen = set()
        while frontier:
            node = frontier.pop()
            seq = node._sequence_nr()
            if seq < start or seq in seen or \
                    type(node).__name__ == "AccumulateGrad":
                continue
            seen.add(seq)
            self._node_weight[seq] = self._node_weight.get(seq, 1) * weight
            frontier += [n for n, _ in node.next_functions if n is not None]

    def _weight(self) -> int:
        node = torch._C._current_autograd_node()
        w = self._weights[-1]
        if node is not None:
            w *= self._node_weight.get(node._sequence_nr(), 1)
        return w

    # -- counting ------------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if not self.paused and not any(_is_fake(t) for t in tree_leaves(
                (args, kwargs, out))):
            self._count(func, args, kwargs, out, self._weight())
        return out

    def _count(self, func, args, kwargs, out, w: int) -> None:
        c = self.counts
        name = func._opname
        if func.namespace in ("_c10d_functional", "_dtensor"):
            kind = _COLLECTIVES.get(name)
            if kind is not None:
                c[("count", kind)] += w
                c[("bytes", kind)] += w * sum(
                    _nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor))
            if name == "shard_dim_alltoall":
                # the same move as the CPU mesh's all-gather counts it
                ranks = _resolve_process_group(args[3]).size()
                c[("shard_move", "all-to-all")] += w * _nbytes(out)
                c[("shard_move", "all-gather")] += \
                    w * ranks * _nbytes(args[0])
            return
        if func.is_view or name in _NO_TRAFFIC:
            return
        formula = flop_registry.get(func.overloadpacket)
        if formula is not None:
            c["flops"] += w * int(formula(*args, **kwargs, out_val=out))
        c["traffic_bytes"] += w * sum(_nbytes(t) for t in tree_leaves(
            (args, kwargs, out)) if isinstance(t, torch.Tensor))


def _card_alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
    """DTensor's move of a shard from one dim to another as a CUDA mesh
    issues it, one all-to-all: on a CPU mesh DTensor falls back to an
    all-gather and a chunk, whose bytes are the whole dim's."""
    return torch.ops._dtensor.shard_dim_alltoall(
        input, gather_dim, shard_dim, mesh.get_group(mesh_dim).group_name)


def _planning():
    """DTensor's planning functions, which run operations of their own on
    meta tensors the first time they meet a placement (the sharding
    propagation through an operation's decomposition, the redistribution
    planner): (owner, attribute name) pairs."""
    from torch.distributed.tensor import _redistribute, _sharding_prop
    return [(_sharding_prop.ShardingPropagator,
             "propagate_op_sharding_non_cached"),
            (_redistribute, "_gen_transform_infos_non_cached")]


@contextlib.contextmanager
def counting():
    """An :class:`OpCounter` active, the SSMs' time loops weighted through
    it, DTensor's planning not counted."""
    from torch.distributed.tensor import placement_types
    counter = OpCounter()
    saved = [(ssm, "scan", ssm.scan),
             (placement_types, "shard_dim_alltoall",
              placement_types.shard_dim_alltoall)]
    ssm.scan = counter.scan
    placement_types.shard_dim_alltoall = _card_alltoall
    for owner, name in _planning():
        fn = getattr(owner, name, None)
        if fn is None:
            continue

        def paused(*args, _fn=fn, **kwargs):
            was, counter.paused = counter.paused, True
            try:
                return _fn(*args, **kwargs)
            finally:
                counter.paused = was

        saved.append((owner, name, fn))
        setattr(owner, name, paused)
    try:
        with counter:
            yield counter
    finally:
        for owner, name, fn in saved:
            setattr(owner, name, fn)


# ---------------------------------------------------------------------------
# the plan: which traces, at which weights
# ---------------------------------------------------------------------------

def _features(cfg: ArchConfig) -> Counter:
    """What a cell's counts are affine in: the layers of each kind and the
    hybrid's shared-block applications (one between segments)."""
    segs = segments(cfg)
    f: Counter = Counter()
    for kind, n in segs:
        f[kind] += n
    if cfg.shared_attn_every:
        f["shared"] = len(segs) - 1
    return f


def _depth_variants(cfg: ArchConfig) -> list[ArchConfig]:
    """One short config more than ``cfg`` has features: one or two of each
    (never none: a parameter shared by the applications of a block has its
    gradient gathered once, and summed from the second on, so the counts
    are affine from one application, not from none)."""
    r = dataclasses.replace
    if cfg.shared_attn_every:                   # (mamba2, shared)
        return [r(cfg, n_layers=2, shared_attn_every=1),
                r(cfg, n_layers=3, shared_attn_every=2),
                r(cfg, n_layers=3, shared_attn_every=1)]
    if cfg.first_dense_layers:                  # (dense, moe)
        return [r(cfg, n_layers=2, first_dense_layers=1),
                r(cfg, n_layers=3, first_dense_layers=2),
                r(cfg, n_layers=3, first_dense_layers=1)]
    return [r(cfg, n_layers=1), r(cfg, n_layers=2)]


def _solve(rows: list[list[int]], target: list[int]) -> list[Fraction]:
    """Weights w with sum_v w_v rows[v] == target, exactly (rows square and
    independent)."""
    n = len(rows)
    a = [[Fraction(rows[v][i]) for v in range(n)] + [Fraction(target[i])]
         for i in range(n)]
    for col in range(n):
        piv = next(r for r in range(col, n) if a[r][col] != 0)
        a[col], a[piv] = a[piv], a[col]
        a[col] = [x / a[col][col] for x in a[col]]
        for r in range(n):
            if r != col and a[r][col] != 0:
                a[r] = [x - a[r][col] * y for x, y in zip(a[r], a[col])]
    return [a[i][n] for i in range(n)]


def plan(cfg: ArchConfig) -> list[tuple[ArchConfig, Fraction]]:
    """(config, weight) of each trace; the weighted sum of their counts is
    the count of ``cfg``."""
    variants = _depth_variants(cfg)
    keys = sorted(set().union(*map(_features, variants)))
    rows = [[1] + [_features(v)[k] for k in keys] for v in variants]
    target = [1] + [_features(cfg)[k] for k in keys]
    return [(v, w) for v, w in zip(variants, _solve(rows, target)) if w]


# ---------------------------------------------------------------------------
# memory
# ---------------------------------------------------------------------------

def _uneven(name: str, t: torch.Tensor) -> str | None:
    if not isinstance(t, DTensor):
        return None
    mesh = t.device_mesh
    ways: Counter = Counter()
    for i, p in enumerate(t.placements):
        if isinstance(p, Shard):
            ways[p.dim] = ways.get(p.dim, 1) * mesh.size(i)
    bad = [d for d, n in ways.items() if t.shape[d] % n]
    return f"{name} {tuple(t.shape)} dims {bad}" if bad else None


def _tree_bytes(tree, prefix: str, uneven: list) -> int:
    from repro_torch.distributed.checkpoint import _flatten
    total = 0
    for path, leaf in _flatten(tree):
        if isinstance(leaf, torch.Tensor):
            total += _nbytes(leaf)
            note = _uneven(prefix + path, leaf)
            if note and note not in uneven:
                uneven.append(note)
    return total


# ---------------------------------------------------------------------------
# one cell
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _Cell:
    run: object              # () -> the step's result
    argument_bytes: int
    out_bytes: object        # result -> bytes
    uneven: list


def _setup(cfg: ArchConfig, kind: str, inputs: dict, cache_len: int, mesh,
           opts: Options) -> _Cell:
    """The cell's model on ``meta`` with DTensor parameters, its state,
    inputs or cache placed on ``mesh``, and its step, not yet run."""
    names = mesh.mesh_dim_names
    shape = dict(zip(names, mesh.shape))
    axes = sh.MeshAxes(fsdp=("pod", "data") if "pod" in names else
                       ("data",), tp="model")
    tp_size = shape["model"]
    n_dev = math.prod(mesh.shape)
    model = Model(cfg, device="meta", dtype=torch.bfloat16,
                  expert_pad=tp_size, vocab_pad=128, remat=opts.remat,
                  constrain=sh.make_constrain(mesh, axes, opts.seq_parallel)
                  if opts.constrain else None)
    # serving: weight-stationary params (TP-only; no per-step FSDP gathers)
    p_axes = sh.MeshAxes(fsdp=(), tp="model") if opts.serve_sharding \
        else axes
    sh.distribute_model(model, mesh, p_axes)
    params = dict(model.named_parameters())
    dp = axes.dp() if len(axes.dp()) > 1 else axes.dp()[0]
    uneven: list = []
    args_b = _tree_bytes(params, "params", uneven)
    if kind == "train":
        step = make_train_step(model, optim.AdamWConfig(), opts.grad_compress,
                               opts.microbatches)
        state = init_train_state(model, opts.grad_compress)
        b = sh.distribute_tree(inputs, sh.batch_specs(axes, inputs), mesh)
        args_b += _tree_bytes(state, "state", uneven) + \
            _tree_bytes(b, "batch", uneven)

        def run():
            return step(state, b)

        def out_bytes(metrics):
            return _tree_bytes(params, "params", uneven) + \
                _tree_bytes(state, "state", uneven) + \
                _tree_bytes(metrics, "metrics", uneven)
        return _Cell(run, args_b, out_bytes, uneven)
    key = "tokens" if kind == "prefill" else "token"
    batch = inputs[key].shape[0]
    if kind == "prefill":
        tok_spec = sh.Spec(dp, None)
        logit_spec = sh.Spec(dp, None, "model")
    else:
        tok_spec = sh.Spec(dp, None) \
            if batch >= n_dev // tp_size else sh.Spec(None, None)
        logit_spec = sh.Spec(*tok_spec, "model")
    cache = model.init_cache(batch, cache_len, dtype=torch.bfloat16)
    cache = sh.distribute_tree(
        cache, sh.cache_specs(cfg, cache, axes, batch, shape), mesh)
    if kind == "prefill":
        b = sh.distribute_tree(inputs, sh.batch_specs(axes, inputs), mesh)
        args_b += _tree_bytes(b, "batch", uneven)
        extra = {k: v for k, v in b.items() if k != "tokens"} or None
    else:
        token = sh.shard_like(inputs["token"], mesh, tok_spec)
        args_b += _nbytes(token) + _tree_bytes(cache, "cache", uneven) \
            + 4                                        # the int32 position

    @torch.no_grad()
    def run():
        if kind == "prefill":
            logits, _ = model.prefill(b["tokens"], cache, extra=extra)
        else:
            logits, _ = model.decode(token, cache, cache_len - 1)
        return logits.redistribute(
            logits.device_mesh, sh.placements(logits.device_mesh, logit_spec))

    def out_bytes(logits):
        return _nbytes(logits) + _tree_bytes(cache, "cache", uneven)
    return _Cell(run, args_b, out_bytes, uneven)


def trace(cfg: ArchConfig, kind: str, inputs: dict, cache_len: int, mesh,
          opts: Options) -> tuple[Counter, object]:
    """Run the cell once at ``cfg`` -> (its counts, its result)."""
    cell = _setup(cfg, kind, inputs, cache_len, mesh, opts)
    with counting() as counter:
        out = cell.run()
    return counter.counts, out


def counts(cfg: ArchConfig, kind: str, inputs: dict, cache_len: int, mesh,
           opts: Options) -> tuple[Counter, object, int]:
    """The cell's counts at ``cfg``'s depth from the traces of :func:`plan`
    -> (counts, the last trace's result, the number of traces)."""
    steps = plan(cfg)
    total: Counter = Counter()
    for variant, w in steps:
        got, out = trace(variant, kind, inputs, cache_len, mesh, opts)
        for k, v in got.items():
            total[k] += w * v
    assert all(v.denominator == 1 for v in total.values()), total
    return Counter({k: int(v) for k, v in total.items()}), out, len(steps)


def cell_record(cfg: ArchConfig, shape_id: str, mesh, opts: Options,
                reduced: bool = False) -> dict:
    """One cell's record on ``mesh`` (its dims named as the production
    mesh's), the inputs :func:`configs.input_specs` gives (``reduced``
    alike): the memory of the full-size cell, the counts of :func:`counts`,
    the roofline."""
    seq, batch, kind = SHAPES[shape_id]
    inputs = input_specs(cfg, shape_id, reduced)
    if reduced:
        seq, batch = min(seq, 128), min(batch, 2)
    cache_len = seq + (cfg.n_prefix if kind == "prefill" and
                       cfg.frontend == "vision_patches" else 0)
    n_dev = math.prod(mesh.shape)
    full = _setup(cfg, kind, inputs, cache_len, mesh, opts)
    got, out, n_traces = counts(cfg, kind, inputs, cache_len, mesh, opts)
    coll_bytes = {k: v for (what, k), v in
                  ((k, v) for k, v in got.items() if isinstance(k, tuple))
                  if what == "bytes"}
    coll_count = {k: v for (what, k), v in
                  ((k, v) for k, v in got.items() if isinstance(k, tuple))
                  if what == "count"}
    moves = {k: v for (what, k), v in
             ((k, v) for k, v in got.items() if isinstance(k, tuple))
             if what == "shard_move"}
    rec = {"shape": shape_id, "mesh": "x".join(map(str, mesh.shape)),
           "n_devices": n_dev, "kind": kind, "reduced": reduced}
    rec["memory"] = {"argument_bytes": full.argument_bytes,
                     "output_bytes": full.out_bytes(out),
                     "temp_bytes": None, "largest_shard": True,
                     "uneven_leaves": full.uneven}
    rec["flops"] = got["flops"]
    rec["traffic_bytes"] = got["traffic_bytes"]
    rec["traffic_note"] = "each local operation's inputs and outputs, unfused"
    rec["collective_bytes"] = coll_bytes
    rec["collective_count"] = coll_count
    rec["shard_moves"] = {"all-to-all": moves.get("all-to-all", 0),
                          "as_all_gather": moves.get("all-gather", 0)}
    rec["loops"] = LOOP_METHOD
    rec["traces"] = n_traces
    spec = CLUSTERS[CLUSTER]
    rec["roofline"] = roofline_terms(
        got["flops"], got["traffic_bytes"], sum(coll_bytes.values()),
        n_dev, peak_flops=spec.peak_flops, hbm_bw=spec.hbm_bw,
        ici_bw=spec.bn / spec.k, ici_links=1.0,
        model_flops=model_flops(cfg, shape_id, batch, seq))
    rec["roofline"]["cluster"] = CLUSTER
    rec["not_reported"] = NOT_REPORTED
    rec["ok"] = True
    return rec


def dryrun_cell(arch_id: str, shape_id: str, multi_pod: bool,
                opts: Options = Options(), tp: int = 16,
                tag: str = "") -> dict:
    """Run one cell on the production mesh (a fake group of 256 or 512
    ranks) and return its record."""
    t0 = time.perf_counter()
    start_fake_group(512 if multi_pod else 256)
    mesh = make_production_mesh(multi_pod=multi_pod, tp=tp,
                                device_type="cpu")
    rec = {"arch": arch_id, "tag": tag} | cell_record(
        get_config(arch_id), shape_id, mesh, opts)
    rec["host_s"] = round(time.perf_counter() - t0, 2)
    return rec


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

def iter_cells(all_cells: bool, arch=None, shape=None, multi_pod=False):
    """(arch, shape, multi_pod, skipped reason or "") in the reference's
    order: every cell on 16x16, then every enabled one on 2x16x16."""
    if not all_cells:
        yield arch, shape, multi_pod, ""
        return
    for mp in (False, True):
        for a in ARCH_IDS:
            cfg = get_config(a)
            for s in SHAPES:
                ok, why = cell_enabled(cfg, s)
                if ok or not mp:
                    yield a, s, mp, "" if ok else why


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--remat", default="full")
    ap.add_argument("--seq-parallel", action="store_true")
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--tp", type=int, default=16)
    ap.add_argument("--serve-sharding", action="store_true")
    ap.add_argument("--grad-compress", default="none")
    ap.add_argument("--no-constrain", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default=RESULTS,
                    help="directory of the records")
    args = ap.parse_args(argv)
    if not args.all and not (args.arch and args.shape):
        ap.error("give --all, or --arch and --shape")
    # the fake group first, as the reference sets XLA_FLAGS before jax
    start_fake_group(512 if args.multi_pod else 256)
    os.makedirs(args.out, exist_ok=True)
    opts = Options(remat=args.remat, constrain=not args.no_constrain,
                   seq_parallel=args.seq_parallel,
                   grad_compress=args.grad_compress,
                   microbatches=args.microbatch,
                   serve_sharding=args.serve_sharding)
    recs = []
    for arch, shape, mp, skipped in iter_cells(args.all, args.arch,
                                               args.shape, args.multi_pod):
        mesh_name = "2x16x16" if mp else "16x16"
        out = _path(args.out, arch, shape, mesh_name, args.tag)
        if skipped:
            rec = {"ok": False, "skipped": skipped, "arch": arch,
                   "shape": shape, "mesh": mesh_name}
            _write(out, rec)
            _write(_path(args.out, arch, shape, "2x16x16", args.tag), rec |
                   {"mesh": "2x16x16"})
            recs.append(rec)
            continue
        if os.path.exists(out) and not args.force:
            print(f"skip (exists): {out}", flush=True)
            continue
        print(f"=== {arch} x {shape} x {mesh_name}", flush=True)
        try:
            rec = dryrun_cell(arch, shape, mp, opts, tp=args.tp,
                              tag=args.tag)
            print(json.dumps({k: rec[k] for k in
                              ("flops", "traffic_bytes", "host_s")}),
                  flush=True)
        except Exception as e:
            rec = {"ok": False, "error": f"{type(e).__name__}: {e}",
                   "traceback": traceback.format_exc()[-2000:],
                   "arch": arch, "shape": shape, "mesh": mesh_name}
            print("FAILED:", rec["error"], flush=True)
        _write(out, rec)
        recs.append(rec)
    return recs


def _path(root, arch, shape, mesh_name, tag=""):
    sfx = f"_{tag}" if tag else ""
    return os.path.join(root, f"{arch}__{shape}__{mesh_name}{sfx}.json")


def _write(path, rec):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)


if __name__ == "__main__":
    main()
