"""The five invariant rules of the port (DESIGN.md §11), with torch
vocabulary: the JAX package's ``analysis.rules`` over ``src/repro_torch/``.

Each rule encodes one load-bearing contract from CHANGES.md/DESIGN.md:

  * ``r1-host-sync``      — hot-path modules make exactly the sanctioned
    host reads of card values and no others (§8's two-phase query
    discipline): ``int``/``float``/``bool`` of a tensor, ``.item()``,
    ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray``, ``torch.equal``,
    branches on a tensor, the ops whose output size depends on the data
    (``nonzero``, ``unique``, ``masked_select``), and copies of pageable
    host buffers to the card, which torch makes synchronous;
  * ``r2-recompile-hazard`` — shape-bearing arguments of the device entry
    points and the engine's pad buffers flow from the bucketing helpers,
    so live traffic only meets shapes warm-up ran;
  * ``r3-wire-protocol``  — cluster code only names whitelisted wire
    dtypes and never imports or calls a pickle-family serializer
    (``torch.save``/``torch.load`` and ``torch.multiprocessing`` included)
    (§10);
  * ``r4-mutation-discipline`` — mutating replica/engine calls in the
    router layer are dominated by a straggler quiesce or live inside an
    ``@under_quiesce``-marked helper (§7's hedged-straggler race);
  * ``r5-aliasing``       — no ``torch.from_numpy`` (or host
    ``torch.as_tensor``) view over a numpy buffer that the same scope later
    mutates (the delta-seal gotcha).

All matching is terminal-name + dotted-prefix based (see ``taint.py``):
single-module analysis cannot resolve imports, and does not need to —
the hot-path vocabulary is pinned by these very rules.  Stdlib and numpy
only: nothing here imports torch.
"""
from __future__ import annotations

import ast
import os
from typing import Dict, List, Optional, Sequence, Set, Tuple

from .engine import Finding, Module, Rule, default_root, qualname_of
from .taint import (FunctionTaint, TaintConfig, _dotted, call_name,
                    iter_functions, terminal_name)

__all__ = ["HostSyncRule", "RecompileHazardRule", "WireProtocolRule",
           "MutationDisciplineRule", "AliasingRule", "default_rules",
           "load_wire_dtypes", "hold_syncs"]


# -- shared vocabulary ------------------------------------------------------

# calls that return card tensors (the JAX package's list under the port's
# names: index and pipeline stages, the kernel wrappers, the engine's batch
# runners); method or function position, terminal name match
DEVICE_FNS = {
    "query", "query_compact", "warm_compact",
    "probe_index", "finish_index", "query_index", "query_index_compact",
    "build_index", "_query_segment", "_query_delta", "_finish_segment",
    "stage_hash", "stage_probe_keys", "stage_bucket_lookup",
    "stage_candidate_gather", "stage_probe_extents", "stage_probe_counts",
    "stage_fused_probe", "stage_dedup", "stage_tombstone", "stage_rerank",
    "stage_merge_pair", "stage_merge_concat",
    "probe_candidates", "l1_distance_chunked",
    "fused_probe", "fused_rerank", "topk_merge", "probe_extents",
    "compact_gather", "rw_hash", "l1_distance", "l1_distance_rows",
    "_run_batch", "run_padded",
}

# IndexState / Segment fields that are card tensors wherever they appear
DEVICE_ATTRS = {"sorted_keys", "sorted_ids", "occ_from", "occ_hist",
                "dataset", "gids"}

# host-side helpers whose *arguments* must already live on the host —
# passing a card tensor forces a transfer inside them
HOST_FNS = {"occupancy_quantile", "max_bucket_occupancy",
            "oracle_candidate_cap", "percentile", "_truncated_total"}

# helpers whose results are sanctioned static-shape sources (R2)
SHAPE_SOURCES = {"bucket_for", "shape_buckets", "buckets",
                 "candidate_ladder", "candidate_ladders", "rung_ladder",
                 "pick_rung", "candidate_bucket", "structure_signature"}

# torch calls and tensor methods that return host values, never a tensor
NEUTRAL_CALLS = {
    "is_tensor", "is_available", "current_device", "device_count", "iinfo",
    "finfo", "device", "_cuda_getCurrentRawStream", "numel", "dim", "size",
    "get_device",
    # host sinks whose result is a host bool (the call itself is a finding)
    "equal", "is_nonzero",
}

# tensor attributes that are host metadata, not the value
TENSOR_METADATA = {"shape", "ndim", "dtype", "itemsize", "nbytes", "device",
                   "is_cuda"}

# torch dtype names: ``t.to(torch.int32)`` converts, ``t.to(device)`` moves
TORCH_DTYPES = {"bool", "uint8", "int8", "int16", "int32", "int64", "uint16",
                "uint32", "uint64", "float16", "float32", "float64",
                "bfloat16", "half", "float", "double", "short", "int",
                "long"}

# ops whose output size depends on the data: the host waits for the card
# to learn it (``bincount`` for its length, ``repeat_interleave`` without
# ``output_size``)
DATA_SIZED = {"nonzero", "unique", "unique_consecutive", "masked_select",
              "argwhere", "bincount", "repeat_interleave"}


def _line_findings_key(node: ast.AST) -> Tuple[int, int]:
    return (getattr(node, "lineno", 0), getattr(node, "col_offset", 0))


def _literal_device(node: ast.AST) -> str:
    """The device type a literal names (``"cuda:0"`` and
    ``torch.device("cuda")`` give ``"cuda"``); ``""`` for any other
    expression."""
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value.split(":")[0]
    if isinstance(node, ast.Call) and call_name(node) in (
            "torch.device", "device") and node.args:
        return _literal_device(node.args[0])
    return ""


def _names_dtype(node: ast.AST) -> bool:
    """An argument of ``.to()`` that names a type, not a device."""
    if isinstance(node, ast.Attribute):
        if node.attr == "dtype":
            return True
        return (_dotted(node.value) == "torch" and node.attr in TORCH_DTYPES)
    if isinstance(node, ast.Call):
        return (call_name(node) == "getattr" and node.args
                and _dotted(node.args[0]) == "torch")
    if isinstance(node, ast.Name):
        return "dtype" in node.id
    return False


def _kwarg(node: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in node.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _move_target(node: ast.Call) -> Optional[ast.AST]:
    """The device a ``.to(...)`` call moves to (None when it only converts
    the type)."""
    dev = _kwarg(node, "device")
    if dev is not None:
        return dev
    for a in node.args:
        if not _names_dtype(a):
            return a
    return None


def _from_host(node: ast.AST, taint: FunctionTaint) -> bool:
    """Python or numpy data: a literal, a host tensor, an ``np.*`` call."""
    if isinstance(node, (ast.Constant, ast.List, ast.Tuple, ast.ListComp)):
        return True
    if isinstance(node, ast.Call) and call_name(node).split(".")[0] in (
            "np", "numpy"):
        return True
    return "host" in taint.tags(node)


def _h2d_copy(node: ast.Call, taint: FunctionTaint) -> bool:
    """A copy of pageable host memory to the card, which torch runs as a
    synchronous copy (the stream drains first)."""
    dotted = call_name(node)
    term = terminal_name(dotted)
    if dotted in ("torch.tensor", "torch.as_tensor") and node.args:
        dev = _kwarg(node, "device")
        if dev is None or _literal_device(dev) == "cpu":
            return False
        if dotted == "torch.tensor":
            return "device" not in taint.tags(node.args[0])
        return _from_host(node.args[0], taint)
    if term in ("to", "cuda") and isinstance(node.func, ast.Attribute):
        if "host" not in taint.tags(node.func.value):
            return False
        if term == "cuda":
            return True
        target = _move_target(node)
        return target is not None and _literal_device(target) != "cpu"
    return False


def _torch_hook(node: ast.Call, taint: FunctionTaint) -> Optional[Set[str]]:
    """Where torch decides by a call's arguments whether its tensor lands on
    the host (tag ``host``) or the card (tag ``device``)."""
    dotted = call_name(node)
    term = terminal_name(dotted)
    if dotted == "torch.from_numpy":
        return {"host"}
    if dotted in ("torch.tensor", "torch.as_tensor") and node.args:
        dev = _kwarg(node, "device")
        if dev is not None:
            return {"host"} if _literal_device(dev) == "cpu" else {"device"}
        if "device" in taint.tags(node.args[0]):
            return {"device"}
        if dotted == "torch.tensor" or _from_host(node.args[0], taint):
            return {"host"}
        return set()
    if term == "cuda" and isinstance(node.func, ast.Attribute):
        return {"device"}
    if term == "to" and isinstance(node.func, ast.Attribute):
        target = _move_target(node)
        if target is None:
            return taint.tags(node.func.value)
        return {"host"} if _literal_device(target) == "cpu" else {"device"}
    return None


# -- R1: host-sync ----------------------------------------------------------

class HostSyncRule(Rule):
    """Flag host reads of card values and device-value branching in hot
    paths.

    Scope: the staged pipeline, the segmented index, the kernels, the
    serving engine, the ``repro_torch.obs`` hot-path helpers, the language
    models and the greedy decode loop of ``examples/generate.py`` — the
    modules where an unplanned ``.item()`` / ``int()`` / ``.cpu()`` on a
    card tensor stalls the device pipeline per batch.  ``repro_torch/obs/``
    is in scope because its primitives (``span``, ``record_ms``, the
    registry facade) run inside every batch.  The sanctioned reads (the §8
    phase-A rung pick, seal-time cap derivation, compaction's host
    materialization, the batch-boundary result conversion, and the flight
    recorder's slow-exemplar preview) carry inline allows with their
    justification.

    A device value is the result of a ``torch.*`` call, of a ``DEVICE_FNS``
    call, a ``DEVICE_ATTRS`` field, or anything computed from one; tensor
    metadata (``.shape``, ``.dtype``, ``.device``, ``.numel()``, ...) and
    the ``NEUTRAL_CALLS`` are host values.  ``torch.from_numpy`` and host
    ``torch.tensor``/``torch.as_tensor`` results are host tensors: moving
    one to a device (``.to(device)``, ``.cuda()``) is a synchronous copy.
    """

    id = "r1-host-sync"
    description = "host sync on a device value in a hot-path module"

    # the port adds the language models, whose decode step runs once a
    # token, and the greedy decode loop of ``examples/generate.py``
    SCOPE = ("repro_torch/core/pipeline.py", "repro_torch/core/segments.py",
             "repro_torch/core/index.py", "repro_torch/serve/engine.py",
             "repro_torch/kernels/", "repro_torch/obs/", "repro_torch/models/",
             "repro_torch/examples/generate.py")

    def applies(self, path: str) -> bool:
        return path.startswith(self.SCOPE)

    def _config(self) -> TaintConfig:
        return TaintConfig(
            call_hook=_torch_hook,
            source_calls={fn: "device" for fn in DEVICE_FNS},
            source_prefixes={"torch": "device"},
            source_attrs={a: "device" for a in DEVICE_ATTRS},
            clearing_calls={"int", "float", "bool", "item", "tolist", "cpu",
                            "numpy", "asarray", "array", "len"} | HOST_FNS,
            neutral_calls=set(NEUTRAL_CALLS),
            clearing_attrs=set(TENSOR_METADATA),
        )

    def run(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        for stack, fn in iter_functions(mod.tree):
            taint = FunctionTaint(fn, self._config())
            symbol = qualname_of(list(stack) + [fn])
            for node in ast.walk(fn):
                f = self._check_node(node, taint, mod, symbol)
                if f is not None:
                    out.append(f)
        out.sort(key=lambda f: (f.line, f.col))
        return out

    @staticmethod
    def _dev(taint: FunctionTaint, *nodes: ast.AST) -> bool:
        return any("device" in taint.tags(n) for n in nodes)

    def _check_node(self, node: ast.AST, taint: FunctionTaint, mod: Module,
                    symbol: str) -> Optional[Finding]:
        if isinstance(node, ast.Call):
            msg = self._call_message(node, taint)
            if msg is not None:
                return self._finding(node, mod, symbol, msg)
        elif isinstance(node, (ast.If, ast.While)):
            if "device" in taint.tainted_in_branch_test(node.test):
                return self._finding(
                    node.test, mod, symbol,
                    "python branch on a device value forces a host sync")
        elif isinstance(node, ast.IfExp):
            if "device" in taint.tainted_in_branch_test(node.test):
                return self._finding(
                    node.test, mod, symbol,
                    "conditional expression on a device value forces a "
                    "host sync")
        return None

    def _call_message(self, node: ast.Call, taint: FunctionTaint
                      ) -> Optional[str]:
        dotted = call_name(node)
        term = terminal_name(dotted)
        method = isinstance(node.func, ast.Attribute)
        recv = node.func.value if method else None
        torch_fn = dotted.startswith("torch.")
        if term in ("int", "float", "bool") and dotted == term:
            if self._dev(taint, *node.args):
                return f"{term}() on a device value forces a host sync"
        elif term in ("item", "tolist", "cpu", "numpy") and method:
            if self._dev(taint, recv):
                return f".{term}() on a device value forces a host sync"
        elif term == "to" and method and self._dev(taint, recv):
            target = _move_target(node)
            if target is not None and _literal_device(target) == "cpu":
                return ".to('cpu') on a device value forces a host sync"
        elif term in ("asarray", "array", "ascontiguousarray") and (
                dotted.startswith("np.") or dotted.startswith("numpy.")):
            if self._dev(taint, *node.args):
                return f"np.{term}() on a device value copies it to host"
        elif term in ("equal", "is_nonzero"):
            if torch_fn or self._dev(taint, *node.args, *(
                    [recv] if recv is not None else [])):
                return (f"torch.{term}() reads a device result back to the "
                        "host")
        elif term in DATA_SIZED:
            if torch_fn or (method and self._dev(taint, recv)):
                return (f"{term}() sizes its output by the data: the host "
                        "waits for the device")
        elif dotted == "torch.where" and len(node.args) == 1:
            return ("torch.where(cond) is nonzero(): the host waits for "
                    "the device")
        elif term in HOST_FNS:
            if self._dev(taint, *node.args) or self._dev(
                    taint, *(kw.value for kw in node.keywords)):
                return (f"host-side helper {term}() called with a device "
                        "value (forces a transfer per call)")
        if _h2d_copy(node, taint):
            return ("copy of a pageable host buffer to the device runs "
                    "synchronously (the stream drains first)")
        return None

    def _finding(self, node: ast.AST, mod: Module, symbol: str,
                 message: str) -> Finding:
        line, col = _line_findings_key(node)
        return Finding(rule=self.id, path=mod.path, line=line, col=col,
                       symbol=symbol, message=message)


def hold_syncs(stacks: Dict[str, Sequence[Tuple[str, int, str]]],
               sanctioned: Sequence[dict]) -> Tuple[List[str], List[str]]:
    """Hold host syncs observed at run time against the lint.

    ``stacks`` maps each observed sync site (``path:line`` of its innermost
    frame inside the package) to its frames inside the package, innermost
    first, as ``(path, line, function)`` with package-rooted posix paths;
    ``sanctioned`` is the ``--json`` output's list.  A sync is sanctioned
    at its innermost frame: when that frame lies in the lines of an allowed
    or baselined ``r1-host-sync`` finding.  Only a frame inside one of
    ``HOST_FNS`` passes the sync on to its caller, since the lint flags a
    host helper's read at its call site.  Returns (the sites inside r1's
    scope that nothing sanctions — syncs the lint missed, the sanctioned r1
    findings, as ``path:line``, that no observed sync was sanctioned
    by)."""
    spans: Dict[str, List[Tuple[int, int, int]]] = {}
    for ent in sanctioned:
        if ent["rule"] == HostSyncRule.id:
            spans.setdefault(ent["path"], []).append(
                (ent["line"], *ent["lines"]))
    scope = HostSyncRule()
    hit: Set[Tuple[str, int]] = set()
    missed = []
    for site, frames in stacks.items():
        covering: Set[Tuple[str, int]] = set()
        for path, line, fn in frames:
            covering = {(path, at) for at, lo, hi in spans.get(path, ())
                        if lo <= line <= hi}
            if covering or fn not in HOST_FNS:
                break
        hit |= covering
        if frames and scope.applies(frames[0][0]) and not covering:
            missed.append(site)
    unhit = sorted({f"{path}:{at}" for path, found in spans.items()
                    for at, _, _ in found if (path, at) not in hit})
    return sorted(missed), unhit


# -- R2: recompile-hazard ---------------------------------------------------

class RecompileHazardRule(Rule):
    """Shape-bearing args of device entry points must flow from bucketing.

    The port has no jit: what this rule guards on the card is the set of
    shapes warm-up has run.  Warm-up runs every (batch bucket x rung) so
    that a live batch meets built kernels, warm allocator pools and sized
    workspaces; a shape argument that carries a raw data-dependent value
    (``len(...)``, ``.shape``, a device-call result) instead of flowing
    through ``bucket_for``/``pick_rung``/``rung_ladder``-style bucketing
    conjures shapes warm-up never saw — and a shape set that is not closed
    is what CUDA graphs per (bucket, rung) cannot capture.  Pad-buffer
    shapes (``torch.zeros``/``torch.empty``/``torch.full``/``np.zeros``)
    in the engine and router are checked the same way.
    """

    id = "r2-recompile-hazard"
    description = "device entry-point shape arg not derived from bucketing"

    SCOPE = ("repro_torch/serve/engine.py", "repro_torch/core/segments.py",
             "repro_torch/core/index.py", "repro_torch/cluster/router.py")
    PAD_SCOPE = ("repro_torch/serve/engine.py",
                 "repro_torch/cluster/router.py")
    PAD_CALLS = {"torch.zeros", "torch.empty", "torch.full", "np.zeros",
                 "numpy.zeros"}

    # terminal call name -> (positional indices, kwarg names) that are
    # static shape-bearing arguments
    CONSUMERS: Dict[str, Tuple[Tuple[int, ...], Tuple[str, ...]]] = {
        "_finish_segment": ((1, 2), ("cbucket", "c_cap")),
        "finish_index": ((1, 2), ("cbucket", "c_cap")),
        "stage_fused_probe": ((5,), ("cbucket", "c_cap")),
    }

    def applies(self, path: str) -> bool:
        return path.startswith(self.SCOPE)

    def _config(self) -> TaintConfig:
        cfg = TaintConfig(
            source_calls={fn: "dyn" for fn in DEVICE_FNS},
            source_prefixes={"torch": "dyn"},
            source_attrs={"shape": "dyn", "size": "dyn"},
            clearing_calls=set(),
        )
        cfg.source_calls["len"] = "dyn"
        cfg.source_calls["numel"] = "dyn"
        # bucketing helpers override: their results are sanctioned statics
        for fn in SHAPE_SOURCES:
            cfg.source_calls[fn] = "src"
        cfg.clearing_attrs = set()      # .shape must taint here, not clear
        return cfg

    def run(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        for stack, fn in iter_functions(mod.tree):
            taint = FunctionTaint(fn, self._config())
            symbol = qualname_of(list(stack) + [fn])
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                dotted = call_name(node)
                term = terminal_name(dotted)
                if term in self.CONSUMERS:
                    out.extend(self._check_consumer(
                        node, term, taint, mod, symbol))
                elif dotted in self.PAD_CALLS and mod.path.startswith(
                        self.PAD_SCOPE):
                    out.extend(self._check_pad_shape(
                        node, taint, mod, symbol))
        out.sort(key=lambda f: (f.line, f.col))
        return out

    def _hazard(self, tags: Set[str]) -> bool:
        return "dyn" in tags and "src" not in tags

    def _check_consumer(self, node: ast.Call, term: str,
                        taint: FunctionTaint, mod: Module,
                        symbol: str) -> List[Finding]:
        pos, kws = self.CONSUMERS[term]
        out = []
        for idx in pos:
            if idx < len(node.args) and self._hazard(
                    taint.tags(node.args[idx])):
                out.append(self._finding(
                    node.args[idx], mod, symbol,
                    f"shape-bearing arg {idx} of {term}() does not flow "
                    "from bucket_for/candidate_ladder/rung_ladder (a shape "
                    "warm-up never ran, per distinct value)"))
        for kw in node.keywords:
            if kw.arg in kws and self._hazard(taint.tags(kw.value)):
                out.append(self._finding(
                    kw.value, mod, symbol,
                    f"shape-bearing kwarg {kw.arg}= of {term}() does not "
                    "flow from bucketing helpers"))
        return out

    def _check_pad_shape(self, node: ast.Call, taint: FunctionTaint,
                         mod: Module, symbol: str) -> List[Finding]:
        if not node.args:
            return []
        shape = node.args[0]
        elts = shape.elts if isinstance(shape, (ast.Tuple, ast.List)) \
            else [shape]
        out = []
        for elt in elts:
            if self._hazard(taint.tags(elt)):
                out.append(self._finding(
                    elt, mod, symbol,
                    "pad-buffer dimension is data-dependent without "
                    "flowing through a shape bucket (bucket_for/"
                    "shape_buckets) — each distinct size is a shape "
                    "warm-up never ran"))
        return out

    def _finding(self, node: ast.AST, mod: Module, symbol: str,
                 message: str) -> Finding:
        line, col = _line_findings_key(node)
        return Finding(rule=self.id, path=mod.path, line=line, col=col,
                       symbol=symbol, message=message)


# -- R3: wire-protocol ------------------------------------------------------

def load_wire_dtypes(path: Optional[str] = None) -> Tuple[object, ...]:
    """``transport.WIRE_DTYPES`` read from the AST of its assignment: every
    ``np.<dtype>`` the expression names, in order.  The file is parsed, not
    executed — it imports its package relatively (``from . import shm``)
    and the package imports torch."""
    import numpy as np
    path = path or os.path.join(default_root(), "cluster", "transport.py")
    with open(path, "r", encoding="utf-8") as f:
        tree = ast.parse(f.read(), filename=path)
    for node in tree.body:
        if isinstance(node, ast.Assign):
            targets, value = node.targets, node.value
        elif isinstance(node, ast.AnnAssign) and node.value is not None:
            targets, value = [node.target], node.value
        else:
            continue
        if not any(isinstance(t, ast.Name) and t.id == "WIRE_DTYPES"
                   for t in targets):
            continue
        out = []
        for sub in ast.walk(value):
            if (isinstance(sub, ast.Attribute)
                    and _dotted(sub.value) in ("np", "numpy")
                    and sub.attr != "dtype"):
                out.append(np.dtype(getattr(np, sub.attr)))
        return tuple(out)
    raise ValueError(f"{path} assigns no WIRE_DTYPES")


class WireProtocolRule(Rule):
    """Cluster code: whitelisted dtypes only, and no pickle family.

    Every explicit ``np.<dtype>`` literal under ``cluster/`` must be on
    ``transport.WIRE_DTYPES`` — cluster arrays are wire-adjacent by
    construction (queries, WAL records, payload transfers all cross the
    framing), and an off-whitelist dtype would only surface as a
    ``TypeError`` at send time on some rarely-hit path.  The whitelist is
    read from the runtime codec's own assignment, so the rule cannot drift
    from it.

    The pickle ban covers whole modules (``pickle`` et al.), the
    pickle-backed corners of otherwise-legitimate packages
    (``multiprocessing.reduction``/``connection``/``managers`` and
    ``torch.multiprocessing``, banned by dotted prefix; the §13 slab fast
    path's ``shared_memory``/``resource_tracker`` stay legal), and the
    calls ``torch.save``/``torch.load``, which pickle.
    """

    id = "r3-wire-protocol"
    description = "off-whitelist dtype or pickle-family import in cluster/"

    SCOPE = ("repro_torch/cluster/",)
    TRANSPORT = "repro_torch/cluster/transport.py"
    FORBIDDEN_IMPORTS = {"pickle", "cPickle", "marshal", "shelve", "dill",
                         "cloudpickle"}
    # dotted-prefix bans inside packages whose other submodules are legal
    FORBIDDEN_PREFIXES = ("multiprocessing.reduction",
                          "multiprocessing.connection",
                          "multiprocessing.managers",
                          "torch.multiprocessing")
    FORBIDDEN_CALLS = {"torch.save", "torch.load"}
    DTYPE_CALLS: Dict[str, int] = {
        # terminal name -> positional index of the dtype argument
        "asarray": 1, "ascontiguousarray": 1, "array": 1, "frombuffer": 1,
        "zeros": 1, "ones": 1, "empty": 1, "full": 2,
    }

    def __init__(self):
        import numpy as np
        self._np = np
        self._whitelist = set(load_wire_dtypes())

    def applies(self, path: str) -> bool:
        return path.startswith(self.SCOPE)

    def _banned_import(self, name: str) -> bool:
        if name.split(".")[0] in self.FORBIDDEN_IMPORTS:
            return True
        return any(name == p or name.startswith(p + ".")
                   for p in self.FORBIDDEN_PREFIXES)

    def run(self, mod: Module) -> List[Finding]:
        out: List[Finding] = []
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    if self._banned_import(alias.name):
                        out.append(self._finding(
                            node, mod, "",
                            f"import of {alias.name!r} under cluster/: the "
                            "wire protocol is pickle-free by design "
                            "(DESIGN.md §10)"))
            elif isinstance(node, ast.ImportFrom):
                base = node.module or ""
                # `from multiprocessing import reduction` names the banned
                # submodule in the alias, not the module field
                names = [base] + [f"{base}.{a.name}" if base else a.name
                                  for a in node.names]
                if any(self._banned_import(n) for n in names if n):
                    out.append(self._finding(
                        node, mod, "",
                        f"import from {node.module!r} under cluster/: the "
                        "wire protocol is pickle-free by design "
                        "(DESIGN.md §10)"))
            elif isinstance(node, ast.Call):
                dotted = call_name(node)
                if dotted in self.FORBIDDEN_CALLS:
                    out.append(self._finding(
                        node, mod, "",
                        f"{dotted}() under cluster/ pickles its payload: "
                        "the wire protocol is pickle-free by design "
                        "(DESIGN.md §10)"))
                out.extend(self._check_dtype_literal(node, mod))
        if mod.path == self.TRANSPORT:
            out.extend(self._check_whitelist_definition(mod))
        out.sort(key=lambda f: (f.line, f.col))
        return out

    def _dtype_exprs(self, node: ast.Call):
        dotted = call_name(node)
        term = terminal_name(dotted)
        if term not in self.DTYPE_CALLS or not (
                dotted.startswith("np.") or dotted.startswith("numpy.")):
            return
        idx = self.DTYPE_CALLS[term]
        if idx < len(node.args):
            yield node.args[idx]
        for kw in node.keywords:
            if kw.arg == "dtype":
                yield kw.value

    def _check_dtype_literal(self, node: ast.Call,
                             mod: Module) -> List[Finding]:
        out = []
        for expr in self._dtype_exprs(node):
            if not isinstance(expr, ast.Attribute):
                continue
            root = _dotted(expr).split(".")[0]
            if root not in ("np", "numpy"):
                continue
            name = expr.attr
            try:
                dt = self._np.dtype(getattr(self._np, name))
            except (AttributeError, TypeError):
                continue
            if dt not in self._whitelist:
                out.append(self._finding(
                    expr, mod, "",
                    f"dtype np.{name} is not on the wire whitelist "
                    "(transport.WIRE_DTYPES); it cannot cross the framing"))
        return out

    def _check_whitelist_definition(self, mod: Module) -> List[Finding]:
        has_whitelist, code_from_whitelist = False, False
        for node in mod.tree.body:
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                targets = [node.target]
            else:
                continue
            names = {t.id for t in targets if isinstance(t, ast.Name)}
            if "WIRE_DTYPES" in names:
                has_whitelist = True
            if "_DTYPE_CODE" in names or "_DTYPES" in names:
                refs = {n.id for n in ast.walk(node.value)
                        if isinstance(n, ast.Name)}
                if "WIRE_DTYPES" in refs:
                    code_from_whitelist = True
        out = []
        if not has_whitelist:
            out.append(self._finding(
                mod.tree, mod, "",
                "transport.py must define WIRE_DTYPES (the shared codec/"
                "analyzer whitelist)"))
        elif not code_from_whitelist:
            out.append(self._finding(
                mod.tree, mod, "",
                "transport's dtype code table must derive from WIRE_DTYPES "
                "(codec and whitelist drifting apart)"))
        return out

    def _finding(self, node: ast.AST, mod: Module, symbol: str,
                 message: str) -> Finding:
        line, col = _line_findings_key(node)
        return Finding(rule=self.id, path=mod.path, line=line, col=col,
                       symbol=symbol, message=message)


# -- R4: mutation-discipline ------------------------------------------------

class MutationDisciplineRule(Rule):
    """Mutating replica/engine calls must be quiesce-dominated (§7).

    Engines are not thread-safe versus mutation: the race is a hedged
    straggler's query future still running when a mutation lands.  In the
    router layer, every call to a mutating method must either (a) appear
    after a ``_quiesce()`` call in the same function (linear
    statement-order dominance — a conservative approximation that matches
    how the router is written), (b) live in a function marked
    ``@under_quiesce`` (whose own call sites then carry the obligation,
    since the marker makes the function count as a mutator), or (c) be in
    ``__init__`` (single-threaded construction).  Mutator bound methods
    handed to a thread pool are flagged unconditionally.
    """

    id = "r4-mutation-discipline"
    description = "mutating call not dominated by a straggler quiesce"

    SCOPE = ("repro_torch/cluster/router.py", "repro_torch/cluster/remote.py",
             "repro_torch/cluster/replica.py")
    MUTATORS = {"insert", "delete", "compact", "apply_records",
                "adopt_payload", "log_and_apply", "recover",
                "catch_up_from", "kill"}
    EXEMPT_FUNCTIONS = {"__init__"}

    def applies(self, path: str) -> bool:
        return path.startswith(self.SCOPE)

    def run(self, mod: Module) -> List[Finding]:
        local_mutators = self._decorated_functions(mod.tree)
        mutators = self.MUTATORS | local_mutators
        out: List[Finding] = []
        for stack, fn in iter_functions(mod.tree):
            symbol = qualname_of(list(stack) + [fn])
            decorated = self._is_marked(fn)
            exempt = decorated or fn.name in self.EXEMPT_FUNCTIONS
            quiesce_lines = [
                n.lineno for n in ast.walk(fn)
                if isinstance(n, ast.Call)
                and terminal_name(call_name(n)) in ("_quiesce", "quiesce")]
            first_quiesce = min(quiesce_lines) if quiesce_lines else None
            local_defs = {n.name: n for n in ast.walk(fn)
                          if isinstance(n, ast.FunctionDef) and n is not fn}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call):
                    continue
                term = terminal_name(call_name(node))
                if term == "submit":
                    out.extend(self._check_submit(
                        node, mutators, local_defs, mod, symbol))
                    continue
                if term not in mutators:
                    continue
                if self._own_def(node, term, fn):
                    continue
                if exempt:
                    continue
                if first_quiesce is not None and node.lineno > first_quiesce:
                    continue
                out.append(self._finding(
                    node, mod, symbol,
                    f"mutating call {term}() is not dominated by a "
                    "_quiesce() in this function and the function is not "
                    "marked @under_quiesce — a hedged straggler's query "
                    "may still be in flight (DESIGN.md §7)"))
        out.sort(key=lambda f: (f.line, f.col))
        return out

    @staticmethod
    def _own_def(node: ast.Call, term: str, fn: ast.FunctionDef) -> bool:
        """A bare recursive self-call inside its own def is not a site."""
        return isinstance(node.func, ast.Name) and node.func.id == fn.name

    @staticmethod
    def _is_marked(fn: ast.FunctionDef) -> bool:
        for dec in fn.decorator_list:
            name = terminal_name(call_name(dec) if isinstance(dec, ast.Call)
                                 else (dec.id if isinstance(dec, ast.Name)
                                       else getattr(dec, "attr", "")))
            if name == "under_quiesce":
                return True
        return False

    def _decorated_functions(self, tree: ast.AST) -> Set[str]:
        return {fn.name for _, fn in iter_functions(tree)
                if self._is_marked(fn)}

    def _check_submit(self, node: ast.Call, mutators: Set[str],
                      local_defs: Dict[str, ast.FunctionDef], mod: Module,
                      symbol: str) -> List[Finding]:
        if not node.args:
            return []
        fn_arg = node.args[0]
        out = []
        if isinstance(fn_arg, ast.Attribute) and fn_arg.attr in mutators:
            out.append(self._finding(
                fn_arg, mod, symbol,
                f"mutator bound method .{fn_arg.attr} handed to a thread "
                "pool: engine mutations must never run on pool threads "
                "concurrent with queries (DESIGN.md §7)"))
        body: Optional[Sequence[ast.stmt]] = None
        if isinstance(fn_arg, ast.Lambda):
            body = [ast.Expr(value=fn_arg.body)]
        elif isinstance(fn_arg, ast.Name) and fn_arg.id in local_defs:
            body = local_defs[fn_arg.id].body
        if body is not None:
            for stmt in body:
                for sub in ast.walk(stmt):
                    if isinstance(sub, ast.Call) and terminal_name(
                            call_name(sub)) in mutators:
                        out.append(self._finding(
                            sub, mod, symbol,
                            f"mutating call {terminal_name(call_name(sub))}"
                            "() inside a callable handed to a thread pool "
                            "(DESIGN.md §7)"))
        return out

    def _finding(self, node: ast.AST, mod: Module, symbol: str,
                 message: str) -> Finding:
        line, col = _line_findings_key(node)
        return Finding(rule=self.id, path=mod.path, line=line, col=col,
                       symbol=symbol, message=message)


# -- R5: aliasing -----------------------------------------------------------

class AliasingRule(Rule):
    """``torch.from_numpy`` views over later-mutated numpy buffers.

    ``torch.from_numpy(buf)`` always shares ``buf``'s memory, and
    ``torch.as_tensor(buf)`` does too unless it copies to a CUDA device;
    mutating the buffer afterwards silently changes the tensor (the
    delta-seal bug class).  Flagged when the argument's root is a local
    name the same function later subscript-assigns, or a ``self.*`` buffer
    any method of the module subscript-assigns.  ``torch.as_tensor`` is
    flagged when its ``device`` is absent or not a literal CUDA device.
    Any call inside the argument (``.copy()``, ``np.ascontiguousarray``,
    ``np.concatenate``) exempts it — those produce fresh buffers — and
    ``torch.tensor(buf)`` and ``.clone()`` copy.
    """

    id = "r5-aliasing"
    description = "torch.from_numpy view over a numpy buffer mutated later"

    def applies(self, path: str) -> bool:
        return path.startswith("repro_torch/")

    def run(self, mod: Module) -> List[Finding]:
        self_stores = self._module_self_stores(mod.tree)
        out: List[Finding] = []
        for stack, fn in iter_functions(mod.tree):
            symbol = qualname_of(list(stack) + [fn])
            stores = self._local_stores(fn)
            # ``torch.from_numpy(buf).clone()``: the view dies in the copy
            cloned = {id(n.func.value) for n in ast.walk(fn)
                      if isinstance(n, ast.Call)
                      and isinstance(n.func, ast.Attribute)
                      and n.func.attr == "clone"}
            for node in ast.walk(fn):
                if not isinstance(node, ast.Call) or id(node) in cloned:
                    continue
                ctor = self._aliasing_ctor(node)
                if ctor is None:
                    continue
                arg = node.args[0] if node.args else None
                if arg is None or any(isinstance(n, ast.Call)
                                      for n in ast.walk(arg)):
                    continue
                root = self._root_of(arg)
                if root is None:
                    continue
                kind, name = root
                if kind == "local" and any(ln > node.lineno
                                           for ln in stores.get(name, ())):
                    out.append(self._finding(
                        node, mod, symbol,
                        f"{ctor} view over local buffer {name!r} which is "
                        "mutated later in this function — it aliases the "
                        "live buffer; .copy() first"))
                elif kind == "self" and name in self_stores:
                    out.append(self._finding(
                        node, mod, symbol,
                        f"{ctor} view over self.{name} which this module "
                        "mutates in place — it aliases the live buffer; "
                        ".copy() first"))
        out.sort(key=lambda f: (f.line, f.col))
        return out

    @staticmethod
    def _aliasing_ctor(node: ast.Call) -> Optional[str]:
        dotted = call_name(node)
        if dotted == "torch.from_numpy":
            return dotted
        if dotted == "torch.as_tensor":
            dev = _kwarg(node, "device")
            if len(node.args) > 2:
                dev = node.args[2]
            if dev is None or _literal_device(dev) != "cuda":
                return dotted
        return None

    @staticmethod
    def _root_of(arg: ast.AST) -> Optional[Tuple[str, str]]:
        node = arg
        while isinstance(node, ast.Subscript):
            node = node.value
        if isinstance(node, ast.Name):
            return ("local", node.id)
        if isinstance(node, ast.Attribute) and isinstance(
                node.value, ast.Name) and node.value.id == "self":
            return ("self", node.attr)
        return None

    @classmethod
    def _store_root(cls, target: ast.AST) -> Optional[Tuple[str, str]]:
        if isinstance(target, ast.Subscript):
            return cls._root_of(target)
        return None

    def _local_stores(self, fn: ast.FunctionDef) -> Dict[str, List[int]]:
        stores: Dict[str, List[int]] = {}
        for node in ast.walk(fn):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                root = self._store_root(t)
                if root is not None and root[0] == "local":
                    stores.setdefault(root[1], []).append(node.lineno)
        return stores

    def _module_self_stores(self, tree: ast.AST) -> Set[str]:
        stores: Set[str] = set()
        for node in ast.walk(tree):
            targets = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AugAssign):
                targets = [node.target]
            for t in targets:
                root = self._store_root(t)
                if root is not None and root[0] == "self":
                    stores.add(root[1])
        return stores

    def _finding(self, node: ast.AST, mod: Module, symbol: str,
                 message: str) -> Finding:
        line, col = _line_findings_key(node)
        return Finding(rule=self.id, path=mod.path, line=line, col=col,
                       symbol=symbol, message=message)


def default_rules() -> List[Rule]:
    return [HostSyncRule(), RecompileHazardRule(), WireProtocolRule(),
            MutationDisciplineRule(), AliasingRule()]
