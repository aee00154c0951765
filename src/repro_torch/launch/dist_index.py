"""Distributed MP-RW-LSH on ``torch.distributed``, torch counterpart of
``repro.launch.dist_index``.

Layout (the reference's, DESIGN.md Sect. 4):
  * dataset rows sharded over the row axes ('pod', 'data') -> R row shards;
  * the query batch sharded over 'model';
  * every rank probes its row shard for its query block;
  * the per-shard top-k lists are merged over the rank's row group (the
    ranks that share its model index) by an all-gather and one sort
    ('allgather'), by R-1 point-to-point steps round a ring ('ring') or by
    log2 R butterfly steps ('tree'), both folding with the ``topk_merge``
    kernel.  Every rank ends with the global top-k of its query block.

The reference runs one program over XLA's devices; the port runs one
process a rank (``spawn_ranks``), and ``make_mesh`` lays the grid over the
default process group.  Every exchange goes through :class:`Exchange`:

  * backend 'nccl': one card a rank, the tensors stay on the card
    (``exchange == 'device'``);
  * backend 'gloo' with ranks on the card, several of which may share one
    card (NCCL refuses two ranks on one device, gloo takes no CUDA tensor
    in ``all_gather`` or ``send``/``recv``): each exchanged tensor is
    copied to the host before the collective and back after it
    (``exchange == 'host'``); all compute stays on the card;
  * backend 'gloo' on the CPU (the plain kernel versions).

Nothing picks or switches the backend by itself: 'nccl' with no card, or
with more ranks than cards, raises before any collective.  Hash parameters
and the probing template are replicated (the paper's fixed cost, Sect.
3.2), so every shard buckets alike.

Spans (``obs.trace``; each also a ``repro.<name>`` profiler range): a query
is ``dist_query`` (attribute ``index_bytes``, the shard's index on its
device) > ``dist_probe``, ``dist_rerank`` (``slots``, queries x slab width,
and ``queries``), ``dist_exchange`` (one a collective: ``collective`` and
the ``bytes`` it sent) and ``dist_fold`` (the concat sort, or each
``topk_merge`` step); a build is ``dist_build`` > its histogram's
``dist_exchange``.  None synchronizes the card, and with tracing off and no
profiler collecting each is the shared no-op.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import math
import multiprocessing as mp
import os
import pickle
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core import pipeline as pipe
from repro_torch.core.index import IndexConfig, IndexState, build_index
from repro_torch.kernels import _build
from repro_torch.kernels import ops as kops
from repro_torch.obs import trace as obs_trace

__all__ = ["Mesh", "Exchange", "make_mesh", "state_specs", "dist_build_fn",
           "dist_query_fn", "cover_bucket", "spawn_ranks", "run_meshes", "assemble",
           "single_process_group", "rank_device", "REPLICATED", "MERGES"]

ROW_AXES = ("pod", "data")
MERGES = ("allgather", "ring", "tree")
REPLICATED = "replicated"
TIMEOUT_S = 300.0       # every collective's and every spawn's default limit


def _row_axes(names: Sequence[str]) -> Tuple[str, ...]:
    return tuple(a for a in names if a in ROW_AXES)


def rank_device(backend: str, device, rank: int, world: int) -> torch.device:
    """The device rank ``rank`` of ``world`` computes on; raises for a
    backend the device cannot take.  'nccl' takes one card a rank
    (``cuda:rank``); 'gloo' takes the device asked for (``None`` = the
    card), a bare 'cuda' meaning ``cuda:(rank mod cards)``, so that ranks
    share cards when there are fewer cards than ranks; 'fake' (the
    dry-run's group, no peer behind it) as 'gloo'."""
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("backend 'nccl' needs a CUDA card, and none is "
                               "available; pass backend='gloo' to run on the CPU")
        if resolve_device(device).type != "cuda":
            raise ValueError(f"backend 'nccl' runs on the card, not on {device!r}")
        cards = torch.cuda.device_count()
        if world > cards:
            raise ValueError(
                f"backend 'nccl' takes one card a rank: {world} ranks over {cards} "
                "card(s) would put two ranks on one card, which NCCL refuses; pass "
                "backend='gloo' (the exchanges then go through the host)")
        return torch.device("cuda", rank)
    if backend not in ("gloo", "fake"):
        raise ValueError(f"unknown backend {backend!r}: 'nccl', 'gloo' or 'fake'")
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    return dev


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of ranks, as seen from one rank.

    ``shape`` maps each axis name to its size, in the grid's order;
    ``row_ranks`` are the global ranks of this rank's row group (the ranks
    that share its coordinates off the row axes), by row-shard index.
    """

    shape: Dict[str, int]
    rank: int
    coords: Dict[str, int]
    device: torch.device
    backend: str
    row_ranks: Tuple[int, ...]
    row_group: object = dataclasses.field(repr=False, compare=False)

    @property
    def num_row_shards(self) -> int:
        return len(self.row_ranks)

    @property
    def row_index(self) -> int:
        """The flattened index over the row axes: this rank's row shard."""
        return self.row_ranks.index(self.rank)

    @property
    def model_size(self) -> int:
        return self.shape.get("model", 1)

    @property
    def model_index(self) -> int:
        """This rank's query block."""
        return self.coords.get("model", 0)

    @property
    def exchange(self) -> str:
        """'host' when the exchanges copy the card's tensors through the
        host (gloo on the card), else 'device'."""
        return "host" if self.backend == "gloo" and self.device.type == "cuda" else "device"

    def row_slice(self, n_global: int) -> slice:
        """This rank's rows of an (n_global, m) dataset."""
        r = self.num_row_shards
        if n_global % r:
            raise ValueError(f"{n_global} rows do not divide over {r} row shards")
        n = n_global // r
        return slice(self.row_index * n, (self.row_index + 1) * n)

    def query_slice(self, q_global: int) -> slice:
        """This rank's block of a (q_global, m) query batch."""
        s = self.model_size
        if q_global % s:
            raise ValueError(f"{q_global} queries do not divide over {s} model blocks")
        q = q_global // s
        return slice(self.model_index * q, (self.model_index + 1) * q)


def make_mesh(shape: Sequence[int], names: Sequence[str] = ("data", "model"),
              device=None, timeout_s: float = TIMEOUT_S) -> Mesh:
    """The grid ``shape`` over the default process group, with the axis
    names ``('data', 'model')`` (``'pod'`` may come before ``'data'``), as
    ``jax.make_mesh`` lays it: rank r sits at ``np.unravel_index(r, shape)``.

    Every rank creates every row group, in the same order (``new_group``
    is collective), each with the limit ``timeout_s``.  ``device`` as for
    ``rank_device``; a card is made current.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized default process group "
                           "(spawn_ranks or single_process_group)")
    shape, names = tuple(int(s) for s in shape), tuple(names)
    if (len(shape) != len(names) or len(set(names)) != len(names)
            or not set(names) <= {"pod", "data", "model"}):
        raise ValueError(f"mesh axes {names} of shape {shape}: names from "
                         "('pod', 'data', 'model'), one each")
    world, rank = dist.get_world_size(), dist.get_rank()
    if math.prod(shape) != world:
        raise ValueError(f"a {shape} mesh needs {math.prod(shape)} ranks, "
                         f"the group has {world}")
    backend = str(dist.get_backend())
    dev = rank_device(backend, device, rank, world)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    grid = np.arange(world).reshape(shape)
    rows = [names.index(a) for a in _row_axes(names)]
    rest = [d for d in range(len(names)) if d not in rows]
    groups = grid.transpose(rest + rows).reshape(-1, math.prod(shape[d] for d in rows))
    timeout = datetime.timedelta(seconds=timeout_s)
    mine = None
    for ranks in groups.tolist():
        group = dist.new_group(ranks=ranks, timeout=timeout)
        if rank in ranks:
            mine = (tuple(ranks), group)
    coords = dict(zip(names, (int(c) for c in np.unravel_index(rank, shape))))
    return Mesh(dict(zip(names, shape)), rank, coords, dev, backend, mine[0], mine[1])


def state_specs(mesh: Mesh, cfg: IndexConfig) -> Dict[str, object]:
    """For each ``IndexState`` field, the dimension it is sharded on over
    the mesh's row axes, or ``REPLICATED`` (the reference's
    ``PartitionSpec``s: tables by column, rows and their offset by row, the
    parameters, template and the summed histogram everywhere)."""
    return {"params": REPLICATED, "sorted_keys": 1, "sorted_ids": 1, "dataset": 0,
            "template": REPLICATED, "row_offset": 0, "occ_from": 1,
            "occ_hist": REPLICATED}


class Exchange:
    """The collectives of the path over one mesh, and the bytes this rank
    sends through them.

    'nccl' exchanges the card's tensors as they are; 'gloo' on the card
    copies each tensor to the host before the collective and back after it
    (``mesh.exchange == 'host'``).  A group of one rank exchanges nothing.
    ``sent_bytes`` counts each point-to-point payload once and an
    all-gather's or all-reduce's payload once a peer, as a direct exchange
    sends it (gloo may route otherwise).  Each collective is a
    ``dist_exchange`` span whose ``collective`` is its kind
    (``'all_reduce'``, ``'all_gather'``, ``'shift'``) and whose ``bytes``
    are what it added to ``sent_bytes``.
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.host = mesh.exchange == "host"
        self.sent_bytes = 0

    def _sent(self, span, nbytes: int) -> None:
        self.sent_bytes += nbytes
        span.set(bytes=nbytes)

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self.host else t.contiguous()

    def _home(self, t: torch.Tensor) -> torch.Tensor:
        return t.to(self.mesh.device) if self.host else t

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.SUM, world: bool = False):
        """``t`` reduced over the row group (or every rank)."""
        group, size = ((dist.group.WORLD, dist.get_world_size()) if world else
                       (self.mesh.row_group, self.mesh.num_row_shards))
        if size == 1:
            return t
        with obs_trace.span("dist_exchange", collective="all_reduce") as span:
            w = self._wire(t).clone()
            dist.all_reduce(w, op=op, group=group)
            self._sent(span, (size - 1) * w.numel() * w.element_size())
            return self._home(w)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """(R, *t.shape): every row shard's ``t``, by row-shard index."""
        r = self.mesh.num_row_shards
        if r == 1:
            return t[None]
        with obs_trace.span("dist_exchange", collective="all_gather") as span:
            w = self._wire(t)
            out = [torch.empty_like(w) for _ in range(r)]
            dist.all_gather(out, w, group=self.mesh.row_group)
            self._sent(span, (r - 1) * w.numel() * w.element_size())
            return self._home(torch.stack(out))

    def shift(self, t: torch.Tensor, to: int, frm: int) -> torch.Tensor:
        """Send ``t`` to row shard ``to`` and receive its like from row
        shard ``frm``, in one ``batch_isend_irecv``."""
        with obs_trace.span("dist_exchange", collective="shift") as span:
            w = self._wire(t)
            buf = torch.empty_like(w)
            ranks, group = self.mesh.row_ranks, self.mesh.row_group
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, w, ranks[to], group),
                    dist.P2POp(dist.irecv, buf, ranks[frm], group)]):
                req.wait()
            self._sent(span, w.numel() * w.element_size())
            return self._home(buf)


def _rows_on(x, device) -> torch.Tensor:
    """int32 rows of a host array (copied: a memory map reads only these)
    or a tensor, on ``device``."""
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.array(x, np.int32))
    return x.to(device=device, dtype=torch.int32)


def _index_bytes(state: IndexState) -> int:
    """Bytes of a shard's index on its device: rows, tables, occupancy runs,
    histogram and template (the replicated hash parameters aside)."""
    return sum(t.numel() * t.element_size()
               for t in (state.dataset, state.sorted_keys, state.sorted_ids,
                         state.occ_from, state.occ_hist, state.template) if t is not None)


def dist_build_fn(cfg: IndexConfig, mesh: Mesh):
    """Returns ``build(dataset, params) -> IndexState``, called on every rank.

    ``dataset`` is the whole (n_global, m) point set (a host array, which
    may be a memory map, or a tensor), sharded over the row axes: each rank
    builds over its own rows with ``row_offset`` = row-shard index x
    n_local, so that ids are global; raises when n_global does not divide
    over the row shards.  The shard-local occupancy histograms are
    additive, and one all-reduce over the row group gives every rank the
    global view (the reference's ``psum``).  ``params`` (replicated) move
    to the rank's device.  ``build.exchange`` holds the bytes sent.
    """
    exchange = Exchange(mesh)

    def build(dataset, params) -> IndexState:
        with obs_trace.span("dist_build"):
            rows = mesh.row_slice(int(dataset.shape[0]))
            state = build_index(cfg, _rows_on(dataset[rows], mesh.device),
                                row_offset=rows.start, params=params.to(mesh.device))
            state.occ_hist = exchange.all_reduce(state.occ_hist)
            return state

    build.exchange = exchange
    return build


def dist_query_fn(cfg: IndexConfig, mesh: Mesh, merge: str = "allgather",
                  cand_bucket: Optional[int] = None, cand_cap: Optional[int] = None):
    """Returns ``query(state, queries) -> (dists (Q_loc, k), ids (Q_loc, k))``.

    ``queries`` is the whole (Q_global, m) batch, sharded over 'model': the
    rank answers its block of Q_global / (model size) queries, over the
    whole dataset.  ``merge``: 'allgather' | 'ring' | 'tree' ('tree' needs a
    power-of-two number of row shards and raises otherwise).
    ``cand_bucket`` compacts each shard's candidate slab to that width (the
    fused probe's front end, DESIGN.md Sect. 8): the results stay bit for
    bit while it covers the per-shard candidate counts (``cover_bucket``).
    ``cand_cap`` tightens the per-bucket clamp below ``cfg.candidate_cap``
    (the two-level truncate rung, DESIGN.md Sect. 9), for instance
    ``pipeline.occupancy_quantile(state.occ_hist)``: a deterministic
    sorted-prefix truncation, so results are reproducible but no longer
    exact when a bucket exceeds it.  ``query.exchange`` holds the bytes sent.
    """
    if merge not in MERGES:
        raise ValueError(f"unknown merge {merge!r}: one of {MERGES}")
    size = mesh.num_row_shards
    if merge == "tree" and size & (size - 1):
        raise ValueError(f"the tree merge needs a power-of-two number of row shards, "
                         f"got {size}")
    exchange = Exchange(mesh)
    j = mesh.row_index

    def query(state: IndexState, queries):
        with obs_trace.span("dist_query") as span:
            if obs_trace.enabled():
                span.set(index_bytes=_index_bytes(state))
            q = _rows_on(queries[mesh.query_slice(int(queries.shape[0]))], mesh.device)
            with obs_trace.span("dist_probe"):
                ids = pipe.probe_candidates(
                    cfg, state.params, state.template, state.sorted_keys, state.sorted_ids,
                    state.dataset.shape[0], q, cbucket=cand_bucket, c_cap=cand_cap,
                    occ_from=state.occ_from)
            with obs_trace.span("dist_rerank", slots=ids.shape[0] * ids.shape[1],
                                queries=ids.shape[0]):
                d, i = pipe.stage_rerank(cfg, state.dataset, q, ids)  # local top-k
            # global ids; lex-(dist, id) order survives the shift, as the
            # ring and tree folds need
            i = torch.where(i >= 0, i + state.row_offset, -1)
            d = torch.where(i < 0, pipe.BIG_DIST, d)
            if merge == "allgather":
                g = exchange.all_gather(torch.stack([d, i]))          # (R, 2, Q, k)
                with obs_trace.span("dist_fold"):
                    g = g.permute(1, 2, 0, 3).reshape(2, d.shape[0], size * cfg.k)
                    return pipe.stage_merge_concat(g[0], g[1], cfg.k)
            if merge == "ring":
                # R-1 steps; each shard's own list travels the ring and is
                # folded into every accumulator it passes
                trav, acc = torch.stack([d, i]), (d, i)
                for _ in range(size - 1):
                    trav = exchange.shift(trav, (j + 1) % size, (j - 1) % size)
                    with obs_trace.span("dist_fold"):
                        acc = kops.topk_merge(*acc, trav[0], trav[1])
                return acc
            # 'tree': the recursive-doubling butterfly, log2(R) exchange and
            # merge steps; log2(R)/(R-1) of the ring's bytes
            acc, bit = (d, i), 1
            while bit < size:
                peer = exchange.shift(torch.stack(acc), j ^ bit, j ^ bit)
                with obs_trace.span("dist_fold"):
                    acc = kops.topk_merge(*acc, peer[0], peer[1])
                bit <<= 1
            return acc

    query.exchange = exchange
    return query


def cover_bucket(cfg: IndexConfig, mesh: Mesh, state: IndexState, queries,
                 cand_cap: Optional[int] = None) -> int:
    """The smallest candidate-ladder rung (``pipeline.candidate_bucket``)
    that covers every rank's per-query candidate count under ``cand_cap``:
    one probe of the rank's query block and one all-reduce (max) over every
    rank.  ``dist_query_fn(..., cand_bucket=...)`` at it stays bit for bit."""
    cap = cfg.candidate_cap if cand_cap is None else min(cfg.candidate_cap, int(cand_cap))
    q = _rows_on(queries[mesh.query_slice(int(queries.shape[0]))], mesh.device)
    bucket, x_neg = pipe.stage_hash(cfg, state.params, q)
    keys = pipe.stage_probe_keys(cfg, state.params, state.template, bucket, x_neg)
    counts = pipe.stage_probe_counts(dataclasses.replace(cfg, candidate_cap=cap),
                                     state.sorted_keys, keys, state.occ_from)
    top = Exchange(mesh).all_reduce(counts.max().reshape(1).to(torch.int64),
                                    op=dist.ReduceOp.MAX, world=True)
    return pipe.candidate_bucket(int(top), cfg.num_tables * cfg.probes_per_table * cap)


# --------------------------------------------------------------------------
# Rank processes
# --------------------------------------------------------------------------

@contextlib.contextmanager
def single_process_group(backend: str, timeout_s: float = TIMEOUT_S):
    """A default process group of one rank over an in-memory store, for a
    (1, 1) mesh in this process; destroyed on exit.  Raises when a default
    group exists already."""
    if dist.is_initialized():
        raise RuntimeError("a default process group exists already")
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=timeout_s))
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _rank_main(rank, world, init, backend, device, timeout_s, t_spawn, out_dir):
    """One rank: its device (a card's context made), the default group, then
    ``fn(device, *args)`` from ``out_dir/job.pkl``; its result, kernel
    launches and times go to ``out_dir/rank<r>.pkl``, a failure's traceback
    to ``rank<r>.err``."""
    torch.set_num_threads(1)
    try:
        with open(Path(out_dir, "job.pkl"), "rb") as f:
            fn, args = pickle.load(f)
        dev = rank_device(backend, device, rank, world)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
            torch.zeros(1, device=dev)
            torch.cuda.synchronize(dev)
        boot_s = time.time() - t_spawn
        dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=timeout_s))
        ready_s = time.time() - t_spawn
        out = fn(dev, *args)
        _sync(dev)
        report = {"result": out, "launches": dict(_build.LAUNCHES), "device": str(dev),
                  "boot_s": boot_s, "ready_s": ready_s,
                  "seconds": time.time() - t_spawn}
        tmp = Path(out_dir, f"rank{rank}.tmp")
        with open(tmp, "wb") as f:
            pickle.dump(report, f)
        os.replace(tmp, Path(out_dir, f"rank{rank}.pkl"))
        dist.destroy_process_group()
    except BaseException:
        Path(out_dir, f"rank{rank}.err").write_text(traceback.format_exc())
        os._exit(1)     # no teardown: peers may be blocked in a collective


def spawn_ranks(world: int, fn, *args, backend: str = "gloo", device=None,
                timeout_s: float = TIMEOUT_S) -> List[dict]:
    """Run ``fn(device, *args)`` in ``world`` rank processes over one default
    process group, and return each rank's report, by rank: ``result`` (what
    ``fn`` returned: host objects only), ``launches`` (the rank's kernel
    launch counts), ``device``, ``boot_s`` (spawn to a rank with torch
    imported and its card's context made), ``ready_s`` (to the group
    formed) and ``seconds``.

    The ranks start together by the 'spawn' method, each with one torch
    thread, and meet over a ``file://`` store in a temporary directory (no
    port to collide).  ``fn`` and ``args`` are pickled once, into a file of
    that directory that every rank reads after it starts (a rank that had
    them through its start-up pipe would hold the next rank's start until
    it had imported torch); a large array is best handed over as the path
    of an ``.npy`` file, which each rank maps and slices.  Every collective
    has the limit ``timeout_s``; the parent waits at most that long for all
    ranks, and when a rank exits nonzero, leaves no result or outlives the
    limit, kills every rank and raises.
    ``backend`` and ``device`` as for ``rank_device``, checked before any
    rank starts.
    """
    for rank in range(world):
        rank_device(backend, device, rank, world)
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="rwt-ranks-") as tmp:
        init = Path(tmp, "store").as_uri()
        with open(Path(tmp, "job.pkl"), "wb") as f:
            pickle.dump((fn, args), f)
        t_spawn = time.time()
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world, init, backend, device, timeout_s, t_spawn,
                                   tmp)) for r in range(world)]
        try:
            for p in procs:
                p.start()
            deadline = time.monotonic() + timeout_s
            while True:
                failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
                if failed:
                    r = failed[0]
                    err = Path(tmp, f"rank{r}.err")
                    why = err.read_text() if err.exists() else "no traceback"
                    raise RuntimeError(f"rank {r} of {world} failed with exit code "
                                       f"{procs[r].exitcode}:\n{why}")
                if all(p.exitcode == 0 for p in procs):
                    break
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(f"{world} ranks did not finish within {timeout_s} s")
                wait([p.sentinel for p in procs if p.exitcode is None], min(left, 1.0))
            reports = []
            for r in range(world):
                path = Path(tmp, f"rank{r}.pkl")
                if not path.exists():
                    raise RuntimeError(f"rank {r} of {world} exited without a result")
                with open(path, "rb") as f:
                    reports.append(pickle.load(f))
            return reports
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)


def run_meshes(device, data, queries, runs: Sequence[dict],
               timeout_s: float = TIMEOUT_S) -> List[dict]:
    """A rank's work for ``spawn_ranks`` (or, at world 1, for this process
    under ``single_process_group``): for each run, the index built over its
    mesh and the queries answered.

    ``data``: the (n, m) points, or the path of an ``.npy`` file of them
    (memory-mapped); ``queries``: the (Q, m) batch.  Each run is a dict:
    ``shape`` (and ``names``, default ``('data', 'model')``), ``cfg``,
    ``params`` (host ``LshParams``), ``merge`` (default 'allgather'),
    ``cand_bucket`` (an int, or ``'cover'`` for ``cover_bucket``),
    ``cand_cap`` (an int, or from ``cap_quantile``, a quantile of the built
    ``occ_hist``), ``rows`` and ``queries`` (the first rows of ``data`` and
    of ``queries`` only) and ``reps`` (timed calls after the first).  Runs
    in a row that share their mesh, rows, cfg and params share one build.
    Each run's record holds the rank's (d, i) block, its row and model
    index, ``occ_hist``, the cap and bucket taken, ``build_s``,
    ``query_ms`` (host clock, card synchronized, each call after a
    barrier), ``sent_bytes`` (one call's) and ``build_sent_bytes``.
    """
    if isinstance(data, (str, os.PathLike)):
        data = np.load(data, mmap_mode="r")
    meshes: Dict[tuple, Mesh] = {}
    built, out = None, []
    for run in runs:
        cfg = run["cfg"]
        names = tuple(run.get("names", ("data", "model")))
        shape = tuple(run["shape"])
        if (shape, names) not in meshes:
            meshes[shape, names] = make_mesh(shape, names, device, timeout_s)
        mesh = meshes[shape, names]
        rows = run.get("rows") or int(data.shape[0])
        key = (shape, names, rows, cfg)
        if built is None or built[0] != key or built[1] is not run["params"]:
            built = None                        # the previous shard's memory first
            build = dist_build_fn(cfg, mesh)
            _sync(mesh.device)
            t0 = time.perf_counter()
            state = build(data[:rows], run["params"])
            _sync(mesh.device)
            built = (key, run["params"], state, time.perf_counter() - t0,
                     build.exchange.sent_bytes)
        state = built[2]
        batch = queries[:run["queries"]] if run.get("queries") else queries
        cap = run.get("cand_cap")
        if run.get("cap_quantile") is not None:
            cap = pipe.occupancy_quantile(state.occ_hist, run["cap_quantile"])
        bucket = run.get("cand_bucket")
        if bucket == "cover":
            bucket = cover_bucket(cfg, mesh, state, batch, cap)
        query = dist_query_fn(cfg, mesh, run.get("merge", "allgather"), bucket, cap)
        d, i = query(state, batch)
        sent = query.exchange.sent_bytes
        times = []
        for _ in range(run.get("reps", 0)):
            dist.barrier()
            t0 = time.perf_counter()
            query(state, batch)
            _sync(mesh.device)
            times.append((time.perf_counter() - t0) * 1e3)
        out.append({"d": d.cpu().numpy(), "i": i.cpu().numpy(),
                    "row_index": mesh.row_index, "model_index": mesh.model_index,
                    "occ_hist": state.occ_hist.cpu().numpy(), "cand_cap": cap,
                    "cand_bucket": bucket, "build_s": built[3], "query_ms": times,
                    "sent_bytes": sent, "build_sent_bytes": built[4],
                    "exchange": mesh.exchange, "backend": mesh.backend})
    return out


def assemble(rank_runs: Sequence[Sequence[dict]],
             run: int) -> Tuple[np.ndarray, np.ndarray]:
    """The global (Q, k) (d, i) of run ``run`` from every rank's records
    (``run_meshes``' lists, by rank): the model blocks in order.  Every
    rank of a row group must hold the same block (each ends with the
    global top-k of its queries); raises otherwise."""
    blocks: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
    for recs in rank_runs:
        rec = recs[run]
        got = blocks.setdefault(rec["model_index"], (rec["d"], rec["i"]))
        if not (np.array_equal(got[0], rec["d"]) and np.array_equal(got[1], rec["i"])):
            raise RuntimeError(f"run {run}: the ranks of model block "
                               f"{rec['model_index']} disagree")
    order = sorted(blocks)
    return (np.concatenate([blocks[m][0] for m in order]),
            np.concatenate([blocks[m][1] for m in order]))
