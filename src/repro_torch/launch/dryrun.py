"""Multi-pod dry-run: trace one step of every (arch x input-shape x mesh)
cell on one rank of the production world, the JAX package's
``launch/dryrun.py`` in torch.

For each cell the inputs are fake tensors (``FakeTensorMode``: shapes,
dtypes and a device, never allocated), placed by ``models.sharding`` over a
``DeviceMesh`` of the production shape and axis names, on a fake default
process group of 256 (or 512) ranks in this process.  One step runs on
rank 0 under ``implicit_replication()`` and a :class:`Trace`, which counts
below DTensor, on the local shards: the FLOPs, the bytes each dispatched
op reads and writes, the result bytes of every collective by kind, and the
peak of live bytes, arguments included.  ``launch/roofline.py`` turns them
into the three roofline terms of one H100.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-360m --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod] [--json out.json]

Add ``--device cpu`` where there is no card: the fake tensors then say
'cpu' and every kernel wrapper takes its plain version.  The result keeps
the reference's keys, but one ``t_trace_s`` (tracing the step eagerly)
stands for its ``t_lower_s`` and ``t_compile_s``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import time
import weakref
from typing import Any, Dict, Optional

import torch
import torch.distributed as dist
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from repro_torch import resolve_device
from repro_torch.configs import ARCHS, get_config
from repro_torch.kernels import _build
from repro_torch.launch import roofline as rl
from repro_torch.launch.mesh import Grid, make_production_mesh
from repro_torch.models import model as model_lib
from repro_torch.models import sharding as shd
from repro_torch.models import transformer as tf
from repro_torch.models.config import ModelConfig
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step

__all__ = ["SHAPES", "LONG_OK_KINDS", "cell_supported", "abstract_params",
           "input_specs", "fake_world", "Trace", "lower_cell", "lower_ann_cell",
           "main"]

SHAPES = {
    "train_4k":    dict(seq=4096,    batch=256, step="train"),
    "prefill_32k": dict(seq=32768,   batch=32,  step="prefill"),
    "decode_32k":  dict(seq=32768,   batch=128, step="decode"),
    "long_500k":   dict(seq=524288,  batch=1,   step="decode"),
}

# long_500k only for sub-quadratic archs (DESIGN.md §Arch-applicability)
LONG_OK_KINDS = ("ssm", "hybrid")

_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional", "c10d_functional")
_UNWRITTEN = ("empty", "empty_like", "empty_strided", "new_empty",
              "new_empty_strided")


def cell_supported(cfg: ModelConfig, shape: str) -> bool:
    if shape == "long_500k":
        return cfg.kind in LONG_OK_KINDS
    return True


def _fake_mode():
    """The active fake mode, or a new one."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    return detect_fake_mode() or FakeTensorMode()


def abstract_params(cfg: ModelConfig, device=None):
    """The parameter tree as fake tensors on ``device`` (the card unless
    asked for the CPU): the active fake mode's, or a new one's."""
    dev = resolve_device(device)
    with _fake_mode():
        return tf._spec_map(
            lambda s: torch.empty(s[0], dtype=getattr(torch, s[1]), device=dev),
            tf.param_specs(cfg))


def input_specs(cfg: ModelConfig, shape_name: str, mesh, device=None) -> Dict[str, Any]:
    """Fake args + specs + the step callable for one cell (the reference's
    keys ``fn``, ``args``, ``in_shardings``, ``tokens``, ``kind``).  A spec
    is ``models.sharding``'s tuple; ``mesh`` needs axis names and sizes
    only.  Decode's position is a Python int (the port's ``decode_step``
    takes one): the last slot of the cache."""
    info = SHAPES[shape_name]
    b, s = info["batch"], info["seq"]
    step = info["step"]
    dev = resolve_device(device)
    dtype = getattr(torch, cfg.dtype)
    with _fake_mode():
        params = abstract_params(cfg, dev)
        pspecs = shd.param_specs(cfg, params, mesh)
        empty = lambda *shape, dt=torch.int32: torch.empty(shape, dtype=dt, device=dev)

        if step in ("train", "prefill"):
            batch = {"tokens": empty(b, s)}
            if step == "train":
                batch["labels"] = empty(b, s)
            if cfg.frontend:
                batch["frontend"] = empty(b, cfg.frontend_len, cfg.d_model, dt=dtype)
            bspecs = shd.batch_specs(cfg, batch, mesh)
            if step == "prefill":
                fn = lambda p, bt: model_lib.prefill(p, cfg, bt)
                return dict(fn=fn, args=(params, batch), in_shardings=(pspecs, bspecs),
                            tokens=b * s, kind="fwd")
            opt_cfg = OptConfig(moment_dtype=cfg.opt_moment_dtype)
            opt_state = init_opt_state(params, opt_cfg)
            ospecs = {"m": pspecs, "v": pspecs, "step": ()}
            return dict(fn=make_train_step(cfg, opt_cfg), args=(params, opt_state, batch),
                        in_shardings=(pspecs, ospecs, bspecs), tokens=b * s, kind="train")

        # decode: one token against a cache of length s
        caches = model_lib.make_caches(cfg, b, s, dtype=torch.bfloat16, device=dev)
        cspecs = shd.cache_specs(cfg, caches, mesh)
        tokens = empty(b, 1)
        tspec = shd.batch_specs(cfg, {"t": tokens}, mesh)["t"]
        pos = s - 1
        if cfg.kind == "encdec":
            _, ndp, tp = shd.axis_sizes(mesh)
            kvspec = (None, shd.axes_entry(shd.data_axes(mesh)) if b % ndp == 0 else None, None,
                      "model" if cfg.n_kv % tp == 0 else None, None)
            kv_shape = (cfg.n_layers, b, cfg.frontend_len, cfg.n_kv, cfg.head_dim)
            enc_kv = {"ck": empty(*kv_shape, dt=dtype), "cv": empty(*kv_shape, dt=dtype)}
            fn = lambda p, c, t, pos0, ekv: model_lib.decode_step(
                p, cfg, c, t, pos0, enc_kv=ekv)
            return dict(fn=fn, args=(params, caches, tokens, pos, enc_kv),
                        in_shardings=(pspecs, cspecs, tspec, (),
                                      {"ck": kvspec, "cv": kvspec}),
                        tokens=b, kind="decode")
        fn = lambda p, c, t, pos0: model_lib.decode_step(p, cfg, c, t, pos0)
        return dict(fn=fn, args=(params, caches, tokens, pos),
                    in_shardings=(pspecs, cspecs, tspec, ()), tokens=b, kind="decode")


@contextlib.contextmanager
def fake_world(world: int, rank: int = 0):
    """A fake default process group of ``world`` ranks in this process, as
    ``rank`` (no store, no peer, no transfer); destroyed on exit.  Raises
    where a default group exists already."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("the dry-run makes its own fake process group, and a "
                           "default process group is initialized already")
    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _device_mesh(grid: Grid, device: torch.device):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device.type, torch.arange(grid.size).reshape(grid.dims),
                      mesh_dim_names=grid.axis_names)


def _tensors(tree):
    """The tensors of a tree of dicts, lists, tuples and dataclasses."""
    out = []
    for leaf in tree_flatten(tree)[0]:
        if isinstance(leaf, torch.Tensor):
            out.append(leaf)
        elif dataclasses.is_dataclass(leaf) and not isinstance(leaf, type):
            out += _tensors([getattr(leaf, f.name) for f in dataclasses.fields(leaf)])
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class Trace(TorchDispatchMode):
    """Counts what one rank dispatches, below DTensor: a DTensor op is
    passed on (``NotImplemented``), and the ops DTensor then runs on the
    local shards come back here.  The ops DTensor runs to propagate global
    shapes (under the fake mode entered once more) are not counted.

    ``flops``: ``torch.utils.flop_counter``'s formulas.  ``bytes``: each op
    that is no view and returns a tensor, its tensor inputs read once and
    outputs written once.  ``collectives``: ``(namespace.op, result bytes)``
    of each collective.  ``peak_bytes``: the most bytes of storage alive at
    once, counting ``hold``'s arguments from the start.
    """

    def __init__(self, fake_mode=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flop_registry = flop_registry
        self._fake = fake_mode
        self._depth = len(fake_mode.enter_stack) if fake_mode is not None else 0
        self._storages: Dict[int, Any] = {}
        self.flops = 0
        self.bytes = 0
        self.collectives = []
        self.live_bytes = 0
        self.peak_bytes = 0

    def hold(self, tree) -> None:
        """Count the (local) tensors of ``tree`` as alive from now on."""
        from torch.distributed.tensor import DTensor
        for t in _tensors(tree):
            t = t.to_local() if isinstance(t, DTensor) else t
            self._track(t, _nbytes(t))

    def _track(self, t: torch.Tensor, nbytes: Optional[int] = None) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._storages and self._storages[key]() is st:
            return
        size = st.nbytes() if nbytes is None else nbytes
        self._storages[key] = weakref.ref(st, lambda _, k=key, n=size: self._free(k, n))
        self.live_bytes += size
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _free(self, key: int, size: int) -> None:
        self._storages.pop(key, None)
        self.live_bytes -= size

    def _propagating(self) -> bool:
        return self._fake is not None and len(self._fake.enter_stack) > self._depth

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        name = f"{func.namespace}.{func._overloadpacket.__name__}"
        if name == "_c10d_functional.wait_tensor" and self._fake is not None:
            return args[0]      # eager returns its argument; the fake impl a copy
        out = func(*args, **kwargs)
        if self._propagating():
            return out
        outs = _tensors(out)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            if name not in rl.NOT_COUNTED:
                result = outs or _tensors(args[0])
                self.collectives.append((name, sum(map(_nbytes, result))))
        fn = self._flop_registry.get(func._overloadpacket)
        if fn is not None:
            self.flops += fn(*args, **kwargs, out_val=out)
        view = any(r.alias_info is not None and not r.alias_info.is_write
                   for r in func._schema.returns)
        if outs and not view and func._overloadpacket.__name__ not in _UNWRITTEN:
            self.bytes += sum(map(_nbytes, _tensors((args, kwargs)))) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


def _place(spec_tree, tree, device_mesh):
    """``sharding.distribute`` over a tuple of arguments and their specs."""
    return tuple(shd.distribute(t, device_mesh, s) for t, s in zip(tree, spec_tree))


def _trace(fn, args, fake_mode) -> tuple:
    """One call of ``fn(*args)`` under a :class:`Trace` and implicit
    replication; (trace, seconds)."""
    from torch.distributed.tensor.experimental import implicit_replication
    trace = Trace(fake_mode)
    trace.hold(args)
    t0 = time.perf_counter()
    with trace, implicit_replication():
        out = fn(*args)
        trace.hold(out)
    return trace, time.perf_counter() - t0


def lower_cell(arch: str, shape_name: str, multi_pod: bool = False,
               cfg_override: Optional[ModelConfig] = None,
               unroll: bool = True, device=None,
               mesh: Optional[Grid] = None) -> Dict[str, Any]:
    """Trace one cell's step on rank 0 of the production world (or of
    ``mesh``, a ``Grid`` with the production axis names).  ``unroll`` is
    the reference's and changes nothing here: the port's stacks are Python
    loops, every layer traced."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = cfg_override or get_config(arch)
    if not cell_supported(cfg, shape_name):
        return {"arch": cfg.name, "shape": shape_name, "status": "skipped",
                "reason": "full-attention arch; long_500k requires sub-quadratic"}
    dev = resolve_device(device)
    grid = mesh or make_production_mesh(multi_pod=multi_pod)
    with fake_world(grid.size):
        dmesh = _device_mesh(grid, dev)
        with FakeTensorMode() as mode:
            spec = input_specs(cfg, shape_name, grid, dev)
            args = _place(spec["in_shardings"], spec["args"], dmesh)
            trace, t_trace = _trace(spec["fn"], args, mode)
    roof = rl.analyze(trace)
    mf = rl.model_flops(cfg, spec["tokens"],
                        "train" if spec["kind"] == "train" else "fwd")
    return {
        "arch": cfg.name, "shape": shape_name, "mesh": grid.label,
        "status": "ok", "t_trace_s": round(t_trace, 1),
        "model_flops_device": mf / grid.size,
        "useful_flops_frac": (mf / grid.size) / roof.flops if roof.flops else None,
        **roof.summary(),
    }


# ---------------------------------------------------------------------------
# ANN workload cells (the paper's own system on the production mesh)
# ---------------------------------------------------------------------------

def lower_ann_cell(multi_pod: bool = False, n_global: int = 1 << 27,
                   dim: int = 128, q_global: int = 8192,
                   merge: str = "allgather",
                   dataset_dtype: str = "int32", device=None) -> Dict[str, Any]:
    """Trace one distributed query (``dist_index.dist_query_fn``) on rank 0
    of the production world, through ``dist_index.make_mesh``, over the
    rank's shard of an ``n_global``-row index.  The slab is the
    reference's static one (L*P*C candidates a query, no rung), so that no
    count is read; every kernel wrapper takes its plain version on the
    fake tensors (``launches``: the kernel launches the trace made, each
    0).  ``sent_bytes`` is the ``Exchange``'s own count."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.core import hashes as hashes_lib
    from repro_torch.core.index import IndexConfig, IndexState
    from repro_torch.core.walks import WalkTable
    from repro_torch.launch import dist_index as di

    cfg = IndexConfig(num_tables=8, num_hashes=16, width=256, num_probes=100,
                      candidate_cap=8, universe=512, k=50, rerank_chunk=1024,
                      dataset_dtype=dataset_dtype)
    dev = resolve_device(device)
    grid = make_production_mesh(multi_pod=multi_pod)
    with fake_world(grid.size), FakeTensorMode() as mode:
        mesh = di.make_mesh(grid.dims, grid.axis_names, dev)
        n = n_global // mesh.num_row_shards
        lm, u2 = cfg.num_tables * cfg.num_hashes, cfg.universe // 2
        empty = lambda *shape, dt: torch.empty(shape, dtype=dt, device=dev)
        params = hashes_lib.LshParams(
            family="rw", width=float(cfg.width),
            offsets=empty(cfg.num_tables, cfg.num_hashes, dt=torch.float32),
            mix_a=empty(cfg.num_tables, cfg.num_hashes, dt=torch.int64),
            mix_c=empty(cfg.num_tables, dt=torch.int64),
            walks=WalkTable(pairs=empty(lm, dim, u2, dt=torch.int8),
                            prefix=empty(lm, dim, u2 + 1, dt=torch.int32)))
        state = IndexState(
            params=params,
            sorted_keys=empty(cfg.num_tables, n, dt=torch.int64),
            sorted_ids=empty(cfg.num_tables, n, dt=torch.int32),
            dataset=empty(n, dim, dt=getattr(torch, dataset_dtype)),
            template=empty(cfg.probes_per_table, 2 * cfg.num_hashes, dt=torch.int8),
            row_offset=mesh.row_index * n,
            occ_from=empty(cfg.num_tables, n, dt=torch.int32),
            occ_hist=empty(cfg.num_tables, 32, dt=torch.int32))
        queries = empty(q_global, dim, dt=torch.int32)
        slab = cfg.num_tables * cfg.probes_per_table * cfg.candidate_cap
        query = di.dist_query_fn(cfg, mesh, merge=merge, cand_bucket=slab)
        before = dict(_build.LAUNCHES)
        trace, t_trace = _trace(query, (state, queries), mode)
        launches = {k: n - before[k] for k, n in _build.LAUNCHES.items()}
    roof = rl.analyze(trace)
    return {
        "arch": f"mp-rw-lsh-index(n={n_global},m={dim},merge={merge},dt={dataset_dtype})",
        "shape": f"query_q{q_global}_k{cfg.k}",
        "mesh": grid.label,
        "status": "ok", "t_total_s": round(t_trace, 1),
        "sent_bytes": query.exchange.sent_bytes, "launches": launches,
        **roof.summary(),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--ann", action="store_true", help="trace the ANN index cell")
    ap.add_argument("--merge", default="allgather",
                    choices=["allgather", "ring", "tree"])
    ap.add_argument("--dataset-dtype", default="int32", choices=["int32", "int16"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--json", default=None)
    ap.add_argument("--no-unroll", action="store_true",
                    help="the reference's flag (keep layer scans rolled); accepted "
                         "and without effect: the port traces every layer")
    ap.add_argument("--device", default=None,
                    help="the fake tensors' device (default: the card; 'cpu' "
                         "where there is none)")
    args = ap.parse_args(argv)

    results = []
    if args.ann:
        results.append(lower_ann_cell(multi_pod=args.multi_pod, merge=args.merge,
                                      dataset_dtype=args.dataset_dtype,
                                      device=args.device))
    elif args.all:
        for arch in ARCHS:
            for shape in SHAPES:
                try:
                    r = lower_cell(arch, shape, multi_pod=args.multi_pod,
                                   unroll=not args.no_unroll, device=args.device)
                except Exception as e:  # record, keep sweeping
                    r = {"arch": arch, "shape": shape, "status": "error",
                         "error": f"{type(e).__name__}: {e}"[:300]}
                results.append(r)
                print(json.dumps(r), flush=True)
        results.append(lower_ann_cell(multi_pod=args.multi_pod, merge=args.merge,
                                      device=args.device))
    else:
        results.append(lower_cell(args.arch, args.shape, multi_pod=args.multi_pod,
                                  unroll=not args.no_unroll, device=args.device))

    for r in results:
        print(json.dumps(r))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
