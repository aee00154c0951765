"""Sharding rules: parameter, batch and cache specs per (config, mesh), the
JAX package's ``models/sharding.py`` in torch.

Policy (DESIGN.md Sect. 4):
  * batch  -> the data axes ('pod','data') when divisible, else replicated
    (long_500k decode has batch 1 -> replicated batch, KV heads on 'model').
  * tensor-parallel ('model'): attention heads / FFN hidden / experts /
    padded vocab — each dim is sharded only if divisible by the axis size,
    else replicated.
  * fsdp (cfg.fsdp): parameters additionally sharded over the data axes on
    their d_model dim (ZeRO-3 style; DTensor inserts the all-gathers).
  * Mamba block params are replicated; activations still shard by batch.

A spec is plain data: a tuple with one entry a dimension, each entry
``None``, one axis name (``'model'``, ``'data'``) or a tuple of data axes
(``tuple(PartitionSpec)`` of the reference).  The functions read a mesh's axis names and sizes only: a
``launch.mesh.Grid``, a ``DeviceMesh`` with dimension names, or the
distributed index's ``Mesh``.  ``to_shardings`` turns specs into DTensor
placements over a ``DeviceMesh`` and ``distribute`` places a tree.

The port's LM functions run on the placed parameters as they are, under
``torch.distributed.tensor.experimental.implicit_replication()``: the
plain tensors a forward makes (positions, masks, rope tables, zero states)
are replicated, as GSPMD replicates a constant.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import torch

from .config import ModelConfig

__all__ = ["axis_sizes", "param_specs", "batch_specs", "cache_specs",
           "to_shardings", "distribute", "data_axes", "axes_entry", "placements", "is_dtensor",
           "hold_to_batch", "whole_unless_divides", "weight_einsum",
           "run_on_shards",
           "run_sharded"]

_STACKS = ("blocks", "enc_blocks", "dec_blocks")


def _mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    names = getattr(mesh, "mesh_dim_names", None)      # DeviceMesh
    if names is not None:
        return dict(zip(names, mesh.shape))
    names = getattr(mesh, "axis_names", None)          # Grid, a FakeMesh
    if names is not None:
        return {a: int(mesh.shape[a]) for a in names}
    return dict(mesh.shape)                            # dist_index.Mesh


def data_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in _mesh_shape(mesh) if a in ("pod", "data"))


def axes_entry(axes: Tuple[str, ...]):
    """A spec entry over ``axes`` as ``PartitionSpec`` writes it: none as
    ``None``, one axis by its name, several as their tuple."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def axis_sizes(mesh):
    """(sizes by axis name, product of the data axes, the 'model' size)."""
    sizes = _mesh_shape(mesh)
    ndp = math.prod(sizes[a] for a in data_axes(mesh))
    return sizes, ndp, sizes.get("model", 1)


def _div(n: int, by: int) -> bool:
    return by > 0 and n % by == 0


def _map_with_path(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    return fn(path, tree)


def _map_specs(fn, *trees):
    """``fn`` over same-structured trees whose first is a spec tree (tuple
    leaves)."""
    if isinstance(trees[0], dict):
        return {k: _map_specs(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


def param_specs(cfg: ModelConfig, params: Any, mesh):
    """Tree of specs matching the param tree (by leaf path)."""
    _, ndp, tp = axis_sizes(mesh)
    dp = axes_entry(data_axes(mesh))

    def fs(dim_size):  # fsdp spec entry for a d_model-like dim
        return dp if (cfg.fsdp and _div(dim_size, ndp)) else None

    def tpx(dim_size):  # tensor-parallel spec entry
        return "model" if _div(dim_size, tp) else None

    def leaf_spec(names, leaf):
        name = names[-1]
        parent = names[-2] if len(names) > 1 else ""
        shape = tuple(leaf.shape)
        stacked = 1 if any(n in _STACKS for n in names) else 0
        sh = shape[stacked:]  # per-layer shape
        if name == "embed":
            # vocab on 'model' only.  Never fsdp the d_model dim: the logits
            # einsum contracts over d, and a d-dim sharded on the batch axes
            # makes the (B,S,V) logits replicate over 'data' (the
            # reference's comment: 200 GB/device of collectives on gemma-7b).
            base = (tpx(shape[0]), None)
        elif name == "unembed":
            base = (None, tpx(shape[1]))
        elif parent == "attn" and name in ("wq", "wk", "wv", "cwq", "cwk", "cwv"):
            base = (fs(sh[0]), tpx(sh[1]), None)          # (D, NH|KV, hd)
        elif parent == "attn" and name in ("wo", "cwo"):
            base = (tpx(sh[0]), None, fs(sh[2]))          # (NH, hd, D)
        elif parent == "mlp" and name == "wi":
            base = (fs(sh[0]), None, tpx(sh[2]))          # (D, 2, F)
        elif parent == "mlp" and name == "wo":
            base = (tpx(sh[0]), fs(sh[1]))                # (F, D)
        elif parent == "moe" and name == "wi":
            base = (tpx(sh[0]), fs(sh[1]), None, None)    # (E, D, 2, F)
        elif parent == "moe" and name == "wo":
            base = (tpx(sh[0]), None, fs(sh[2]))          # (E, F, D)
        else:  # norms, router, mamba params: replicated
            base = (None,) * len(sh)
        if stacked:
            base = (None,) + base
        base = base[:len(shape)]
        return base + (None,) * (len(shape) - len(base))

    return _map_with_path(leaf_spec, params)


def batch_specs(cfg: ModelConfig, batch: Any, mesh):
    """Each leaf's leading (batch) dim over the data axes when it divides."""
    _, ndp, _ = axis_sizes(mesh)
    dp = axes_entry(data_axes(mesh))

    def leaf_spec(_, leaf):
        first = dp if _div(leaf.shape[0], ndp) else None
        return (first,) + (None,) * (len(leaf.shape) - 1)

    return _map_with_path(leaf_spec, batch)


def cache_specs(cfg: ModelConfig, caches: Any, mesh):
    """KV/SSM caches: leading stack dim replicated, batch on data axes,
    kv-head dim on 'model' when divisible."""
    _, ndp, tp = axis_sizes(mesh)
    dp = axes_entry(data_axes(mesh))

    def leaf_spec(names, leaf):
        name = names[-1]
        shape = tuple(leaf.shape)
        shared = "shared" in names
        stacked = 1 if (shared or cfg.kind == "encdec" or any(
            n == "mamba" or n.startswith("sub") for n in names[:-1])) else 0
        spec = [None] * len(shape)
        if stacked < len(shape) and _div(shape[stacked], ndp):
            spec[stacked] = dp
        if name in ("k", "v") and len(shape) - stacked == 4:
            if _div(shape[stacked + 2], tp):
                spec[stacked + 2] = "model"
        if name == "ssm" and _div(shape[stacked + 1], tp):
            spec[stacked + 1] = "model"
        return tuple(spec)

    return _map_with_path(leaf_spec, caches)


def placements(device_mesh, spec: tuple):
    """DTensor placements of one spec over ``device_mesh``, one a mesh
    dimension: ``Shard(d)`` where that axis names tensor dim d, else
    ``Replicate()``.  A dim over several axes takes ``Shard(d)`` on each of
    them, which DTensor orders row-major by mesh dimension, as JAX orders
    ``('pod', 'data')``.  An axis of one rank splits nothing and takes
    ``Replicate()`` (DTensor would hold a dim sharded over it to its
    reshape rules)."""
    from torch.distributed.tensor import Replicate, Shard
    names = tuple(device_mesh.mesh_dim_names)
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        if list(axes) != sorted(axes, key=names.index):
            raise ValueError(f"spec {spec}: axes {axes} out of the mesh's order {names}")
        for a in axes:
            if device_mesh.shape[names.index(a)] > 1:
                out[names.index(a)] = Shard(d)
    return out


def to_shardings(device_mesh, spec_tree: Any):
    """The spec tree's placements over ``device_mesh`` (a tree of lists)."""
    return _map_specs(lambda s: placements(device_mesh, s), spec_tree)


def distribute(tree: Any, device_mesh, spec_tree: Any):
    """Each leaf of ``tree`` placed by its spec: ``distribute_tensor``, every
    rank cutting its own shard from the global tensor it holds (the same on
    every rank; nothing is sent).  A leaf that is not a tensor (a Python
    int) is kept as it is."""
    from torch.distributed.tensor import distribute_tensor

    def place(spec, leaf):
        if not torch.is_tensor(leaf):
            return leaf
        return distribute_tensor(leaf, device_mesh, placements(device_mesh, spec),
                                 src_data_rank=None)

    return _map_specs(place, spec_tree, tree)


def is_dtensor(t) -> bool:
    """Whether ``t`` is a DTensor (a leaf placed by ``distribute``, or what
    an op on one returned)."""
    if type(t) in (torch.Tensor, torch.nn.Parameter):
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(t, DTensor)


class _GradOnPlacements(torch.autograd.Function):
    """The identity, whose backward puts the gradient on the forward's
    placements."""

    @staticmethod
    def forward(ctx, x):
        ctx.mesh, ctx.placements = x.device_mesh, tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if is_dtensor(g) and tuple(g.placements) != ctx.placements:
            g = g.redistribute(ctx.mesh, ctx.placements)
        return g


def hold_to_batch(x):
    """``x`` on the batch spec of its mesh (dim 0 over the data axes when it
    divides, replicated elsewhere), its gradient too, as GSPMD holds the
    residual stream; ``x`` itself when it is no DTensor.

    Left to DTensor's propagation, the stream drifts: the vocab-sharded
    embedding's rows come back masked-partial and its sums sharded on
    d_model over 'model', a block's output partial; in the backward the
    gradients come back partial or with the batch over both axes (and a
    partial gradient cannot return to a masked-partial output)."""
    if not is_dtensor(x):
        return x
    mesh = x.device_mesh
    want = placements(mesh, batch_specs(None, {"x": x}, mesh)["x"])
    if tuple(x.placements) != tuple(want):
        x = x.redistribute(mesh, want)
    return _GradOnPlacements.apply(x) if x.requires_grad else x


def whole_unless_divides(x, dim: int, n: int):
    """``x`` with every mesh axis that shards ``dim`` replicated instead,
    unless ``n`` divides over that axis, so that ``dim`` can be split into
    (n, ...) where it lies; ``x`` itself when it is no DTensor.  GSPMD picks
    a layout for such a reshape by itself; DTensor refuses to unflatten a
    dim whose leading factor does not divide (heads on 'model' grouped by
    fewer KV heads than ranks)."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard
    mesh, want = x.device_mesh, list(x.placements)
    for i, pl in enumerate(want):
        if isinstance(pl, Shard) and pl.dim % x.ndim == dim % x.ndim \
                and n % mesh.size(i):
            want[i] = Replicate()
    return x if want == list(x.placements) else x.redistribute(mesh, want)


def weight_einsum(eq: str, x, w):
    """``torch.einsum(eq, x, w)`` of an activation ``x`` (its first dim the
    batch) and a weight ``w``; the einsum itself unless ``w`` is a DTensor.

    Sharded, each rank multiplies its own shards, in the layout GSPMD gives
    the reference's products: ``w`` keeps its split over 'model' and is
    gathered over the data axes (fsdp); ``x`` is split by batch over the
    data axes and over 'model' where it has the letter ``w`` is split on;
    the product is split by batch, and over 'model' on that letter, or
    partial where the letter is summed.  DTensor's own einsum flattens dims
    into strided shards that it cannot size on fake tensors, or leaves
    layouts that a later reshape refuses."""
    if not is_dtensor(w):
        return torch.einsum(eq, x, w)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    ins, out = eq.replace(" ", "").split("->")
    xs, ws = ins.split(",")
    mesh = w.device_mesh
    if not is_dtensor(x):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim, run_check=False)
    batch = placements(mesh, batch_specs(None, {"x": x}, mesh)["x"])
    # placements of x, w and the product, and of the local gradients: a
    # rank's gradient of w sums over its batch shard only, and of x over
    # its slice of a letter w is split on (partial over those axes)
    xp, wp, op, xg, wg = [], [], [], [], []
    for i, name in enumerate(mesh.mesh_dim_names):
        wpl = w.placements[i]
        if name == "model" and isinstance(wpl, Shard):
            letter = ws[wpl.dim]
            wp.append(wpl)
            wg.append(wpl)
            xp.append(Shard(xs.index(letter)) if letter in xs else Replicate())
            xg.append(xp[-1] if letter in xs else Partial())
            op.append(Shard(out.index(letter)) if letter in out else Partial())
        else:
            split = isinstance(batch[i], Shard)
            wp.append(Replicate())
            wg.append(Partial() if split else Replicate())
            xp.append(batch[i])
            xg.append(batch[i])
            op.append(Shard(out.index(xs[0])) if split else Replicate())
    y = torch.einsum(eq, x.redistribute(mesh, xp).to_local(grad_placements=xg),
                     w.redistribute(mesh, wp).to_local(grad_placements=wg))
    return DTensor.from_local(y, mesh, op, run_check=False)


def run_on_shards(fn, *args, dims: Tuple[int, ...], ref: int = 0):
    """``fn`` on each rank's shards, for a computation that is elementwise
    along ``dims`` (the batch, the heads): every tensor argument is placed
    as ``args[ref]`` is, kept only where that shards one of ``dims`` (and
    the argument has the dim), else replicated; a plain tensor is first
    taken as replicated; ``None`` and other values pass through.  ``fn``
    runs on the local tensors and its outputs (a tensor or a tuple of them)
    come back as DTensors placed by the same rule.

    DTensor would run each op of ``fn`` through its sharding propagation,
    and refuses some of them: an einsum flattening a batch over 'data'
    with heads over 'model' makes a strided shard, whose sizes it cannot
    take on fake tensors."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    mesh = args[ref].device_mesh
    keep = [pl if isinstance(pl, Shard) and pl.dim in dims else Replicate()
            for pl in args[ref].placements]

    def placed(ndim):
        return [pl if isinstance(pl, Shard) and pl.dim < ndim else Replicate() for pl in keep]

    def local(a):
        if not torch.is_tensor(a):
            return a
        if not is_dtensor(a):
            a = DTensor.from_local(a, mesh, [Replicate()] * mesh.ndim, run_check=False)
        return a.redistribute(mesh, placed(a.ndim)).to_local()

    out = fn(*map(local, args))
    back = lambda t: DTensor.from_local(t, mesh, placed(t.ndim), run_check=False)
    return tuple(map(back, out)) if isinstance(out, tuple) else back(out)


def run_sharded(device, jobs):
    """A rank's work for ``dist_index.spawn_ranks``: for each job
    ``(cfg, params, runs)``, each run's parameters and batch placed by the
    rules over a ``DeviceMesh`` of the default group (``shape`` and
    ``names``, default ``('data', 'model')``), then one step under implicit
    replication; every output comes back whole, on the host, a list of
    outputs a job.

    ``params``: the parameter tree (host tensors, the same on every rank).
    A run: ``step`` ('prefill' -> the logits, 'loss' -> (total, metrics),
    'decode' -> (logits, caches) of one ``decode_step`` at ``pos0`` (default
    0) from zeroed float32 caches of ``cache_len`` slots, the batch's
    ``tokens`` (B, 1), 'grad' -> ((total, metrics), gradients) of
    ``value_and_grad``,
    'train' -> (params, opt_state, metrics) of one ``make_train_step`` step
    from ``init_opt_state``, with ``opt``, an ``OptConfig``) and ``batch``
    (host tensors).
    """
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.train.optimizer import init_opt_state
    from repro_torch.train.train_loop import make_train_step, value_and_grad

    from . import model as model_lib
    from .transformer import tree_map

    def host(t):
        if is_dtensor(t):
            t = t.full_tensor()
        return t.cpu() if torch.is_tensor(t) else t

    def tree_host(out):
        if isinstance(out, (tuple, list)):
            return type(out)(tree_host(o) for o in out)
        return tree_map(host, out)

    meshes, results = {}, []
    for cfg, params, runs in jobs:
        on_device = tree_map(lambda t: t.to(device), params)
        out = []
        for run in runs:
            key = (tuple(run["shape"]), tuple(run.get("names", ("data", "model"))))
            if key not in meshes:
                meshes[key] = init_device_mesh(device.type, key[0], mesh_dim_names=key[1])
            mesh = meshes[key]
            pspecs = param_specs(cfg, on_device, mesh)
            p = distribute(on_device, mesh, pspecs)
            batch = {k: v.to(device) for k, v in run["batch"].items()}
            b = distribute(batch, mesh, batch_specs(cfg, batch, mesh))
            with implicit_replication():
                if run["step"] == "prefill":
                    res = model_lib.prefill(p, cfg, {k: v for k, v in b.items()
                                                     if k != "labels"})
                elif run["step"] == "loss":
                    res = model_lib.train_loss(p, cfg, b)
                elif run["step"] == "decode":
                    caches = model_lib.make_caches(cfg, batch["tokens"].shape[0],
                                                   run["cache_len"], dtype=torch.float32,
                                                   device=device)
                    c = distribute(caches, mesh, cache_specs(cfg, caches, mesh))
                    res = model_lib.decode_step(p, cfg, c, b["tokens"], run.get("pos0", 0))
                elif run["step"] == "grad":
                    res = value_and_grad(cfg)(p, b)
                elif run["step"] == "train":
                    opt = distribute(init_opt_state(on_device, run["opt"]), mesh,
                                     {"m": pspecs, "v": pspecs, "step": ()})
                    res = make_train_step(cfg, run["opt"])(p, opt, b)
                else:
                    raise ValueError(f"unknown step {run['step']!r}")
                out.append(tree_host(res))
        results.append(out)
    return results
