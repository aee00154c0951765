"""The port's lint suite (``repro_torch.analysis``): its five rules on torch
fixtures, the engine, the CLI on the real tree, the dead-code report, and
the suite against the JAX package's ``repro.analysis``.

Fixtures are strings parsed — never imported — under pretend
package-relative paths so rule scoping applies.  Expected findings are
declared in the fixtures themselves with trailing ``# EXPECT <rule-id>``
comments; each test asserts the analyzer reports exactly the expected
(line, rule) set, which covers positives, suppressions, and clean code in
one sweep.
"""
import json
import os
import re
import subprocess
import sys

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.analysis import engine as jengine
from repro.analysis import rules as jrules
from repro_torch.analysis.engine import (Finding, Module,
                                         diff_against_baseline,
                                         load_baseline, run_rules,
                                         write_baseline)
from repro_torch.analysis.rules import (AliasingRule, HostSyncRule,
                                        MutationDisciplineRule,
                                        RecompileHazardRule,
                                        WireProtocolRule, default_rules,
                                        hold_syncs, load_wire_dtypes)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(REPO, "src")
JAX_FIXTURES = os.path.join(REPO, "tests", "fixtures_analysis")
_EXPECT_RE = re.compile(r"#\s*EXPECT\s+([a-z0-9\-]+)")

R1_HOST_SYNC = '''"""R1 fixture: parsed (never imported) under the pretend path
``repro_torch/serve/engine.py``.  Expected findings are tagged EXPECT."""
import numpy as np
import torch

from repro_torch.core import pipeline as pipe


def bad_sync(state, queries):
    counts = torch.sum(queries, dim=-1)
    n = int(counts.max())                               # EXPECT r1-host-sync
    if counts > 0:                                      # EXPECT r1-host-sync
        n += 1
    q = pipe.occupancy_quantile(state.occ_hist, 0.5)    # EXPECT r1-host-sync
    host = np.asarray(counts)                           # EXPECT r1-host-sync
    m = 1 if counts.any() else 0                        # EXPECT r1-host-sync
    return n, q, host, m


def suppressed_sync(queries):
    counts = torch.sum(queries, dim=-1)
    return int(counts.max())  # repro: allow[r1-host-sync] fixture: justified read


def suppressed_above(queries):
    counts = torch.sum(queries, dim=-1)
    # repro: allow[r1-host-sync] fixture: comment-above style
    return float(counts.min())


def clean(queries, warm):
    counts = torch.sum(queries, dim=-1)
    k = counts.shape[0]             # shape metadata never syncs
    if queries is None:             # identity checks are host bookkeeping
        return None
    if k not in warm:               # membership likewise
        warm.add(k)
    results = [counts, counts]
    if not results:                 # truthiness of a host list is fine
        return None
    if counts.numel() and counts.dim() == 1 and counts.is_cuda:
        return pipe.stage_merge_pair(results[0], results[1])
    return counts.to(torch.int64)   # a type conversion stays on the device
'''

R1_TORCH_SINKS = '''"""R1 fixture: the torch sinks, under ``repro_torch/core/pipeline.py``."""
import numpy as np
import torch

from repro_torch.core import pipeline as pipe


def sinks(cfg, data, queries, ids, mask, batch):
    d, i = pipe.stage_rerank(cfg, data, queries, ids)
    a = d.item()                                        # EXPECT r1-host-sync
    b = d.cpu().numpy()                                 # EXPECT r1-host-sync
    c = i.tolist()                                      # EXPECT r1-host-sync
    same = torch.equal(d, i)                            # EXPECT r1-host-sync
    nz = torch.nonzero(d)                               # EXPECT r1-host-sync
    u = i.unique()                                      # EXPECT r1-host-sync
    sel = torch.masked_select(d, mask)                  # EXPECT r1-host-sync
    ok = bool(d.any())                                  # EXPECT r1-host-sync
    back = d.to("cpu")                                  # EXPECT r1-host-sync
    dev = torch.from_numpy(batch).to(queries.device)    # EXPECT r1-host-sync
    one = torch.tensor(3, device=queries.device)        # EXPECT r1-host-sync
    hist = torch.bincount(i)                            # EXPECT r1-host-sync
    where = torch.where(d > 0)                          # EXPECT r1-host-sync
    return a, b, c, same, nz, u, sel, ok, back, dev, one, hist, where


def host_tensors(batch):
    host = torch.from_numpy(batch)
    n = int(host.max())                     # a host tensor: no device read
    t = torch.as_tensor(batch).to(torch.int32)          # no device move
    big = torch.full((), 7, dtype=torch.int32, device="cuda")  # a fill
    return n, t, big, torch.where(host > 0, host, 0)
'''

R1_NEUTRAL = '''"""R1 fixture: host-only torch calls, under ``repro_torch/kernels/ops.py``;
no finding."""
import torch


def neutral(queries, fn, args):
    if not torch.cuda.is_available():
        return None
    dev = torch.cuda.current_device()
    if dev == torch.cuda.device_count() - 1:
        dev = 0
    stream = torch._C._cuda_getCurrentRawStream(dev)
    status = fn(*args, stream)
    if status != 0:
        raise RuntimeError(status)
    big = torch.iinfo(torch.int32).max
    eps = torch.finfo(torch.float32).eps
    if torch.is_tensor(queries) and queries.device == torch.device("cuda"):
        return stream, big, eps
    if queries.numel() and queries.size(0) > queries.get_device():
        return int(big) if queries.numel() > big else float(eps)
    return None
'''

R2_RECOMPILE = '''"""R2 fixture: parsed under the pretend path ``repro_torch/serve/engine.py``."""
import numpy as np
import torch

from repro_torch.core.segments import _finish_segment
from repro_torch.serve.engine import bucket_for


def bad_consumer(cfg, state, gids, tomb, probe_keys, lo, occ, queries):
    counts = torch.amax(occ)
    cb = int(counts.max())                                   # EXPECT r1-host-sync
    return _finish_segment(cfg, cb, 64, state, gids, tomb,   # EXPECT r2-recompile-hazard
                           probe_keys, lo, occ, queries)


def bad_pad(batch, dim):
    n = batch.shape[0]
    return torch.zeros((n, dim), dtype=torch.int32)          # EXPECT r2-recompile-hazard


def bad_np_pad(batch, dim):
    n = len(batch)
    return np.zeros((n, dim), np.int32)                      # EXPECT r2-recompile-hazard


def suppressed_pad(batch, dim):
    n = batch.shape[0]
    return torch.empty((n, dim), dtype=torch.int32)  # repro: allow[r2-recompile-hazard] fixture: justified


def good_consumer(cfg, state, gids, tomb, probe_keys, lo, occ, queries):
    import repro_torch.core.pipeline as pipe
    counts = torch.amax(occ)
    cb, c_cap, _ = pipe.pick_rung(int(counts.max()), 512, 64, 0, 0,  # repro: allow[r1-host-sync] fixture: the sanctioned read
                                  "escalate")
    return _finish_segment(cfg, cb, c_cap, state, gids, tomb,
                           probe_keys, lo, occ, queries)


def good_pad(batch, dim):
    n = batch.shape[0]
    b = bucket_for(n)
    return torch.full((b - n, dim), 0, dtype=torch.int32)
'''

R3_WIRE = '''"""R3 fixture: parsed under the pretend path ``repro_torch/cluster/wal.py``."""
import pickle                                     # EXPECT r3-wire-protocol
import multiprocessing.reduction                  # EXPECT r3-wire-protocol
from multiprocessing import reduction             # EXPECT r3-wire-protocol
from multiprocessing.connection import Client     # EXPECT r3-wire-protocol
import torch.multiprocessing as tmp               # EXPECT r3-wire-protocol
from torch import multiprocessing                 # EXPECT r3-wire-protocol
from multiprocessing import resource_tracker, shared_memory   # legal: slabs

import numpy as np
import torch


def encode(x, path):
    a = np.asarray(x, np.float16)                 # EXPECT r3-wire-protocol
    b = np.zeros((4,), dtype=np.float16)          # EXPECT r3-wire-protocol
    ok = np.asarray(x, np.int64)
    ok2 = np.full((2, 2), -1, np.int32)
    torch.save({"a": ok}, path)                   # EXPECT r3-wire-protocol
    back = torch.load(path)                       # EXPECT r3-wire-protocol
    return pickle.dumps((a, b, ok, ok2, back))


def suppressed(x):
    return np.asarray(x, np.float16)  # repro: allow[r3-wire-protocol] fixture: justified
'''

R4_MUTATION = '''"""R4 fixture: parsed under the pretend path ``repro_torch/cluster/router.py``."""
from .concurrency import under_quiesce


class Router:
    def __init__(self):
        self.replicas[0].recover()                     # ctor is exempt

    def bad_insert(self, recs):
        for rep in self.replicas:
            rep.log_and_apply(recs)                    # EXPECT r4-mutation-discipline

    def good_insert(self, recs):
        self._quiesce()
        for rep in self.replicas:
            rep.log_and_apply(recs)

    @under_quiesce
    def _apply_all(self, recs):
        self.replicas[0].log_and_apply(recs)

    def bad_apply_caller(self, recs):
        self._apply_all(recs)                          # EXPECT r4-mutation-discipline

    def good_apply_caller(self, recs):
        self._quiesce()
        self._apply_all(recs)

    def bad_submit(self):
        return self._pool.submit(self.replicas[0].compact)   # EXPECT r4-mutation-discipline

    def good_submit(self, rows, n):
        return self._pool.submit(self.replicas[0].query, rows, n)

    def suppressed_delete(self, recs):
        self.replicas[0].delete(recs)  # repro: allow[r4-mutation-discipline] fixture: justified
'''

R5_ALIASING = '''"""R5 fixture: parsed under the pretend path ``repro_torch/core/segments.py``."""
import numpy as np
import torch


def bad_local(n, pts):
    buf = np.empty((n, 4), np.int32)
    dev = torch.from_numpy(buf)                        # EXPECT r5-aliasing
    buf[0] = pts
    return dev


def bad_as_tensor(buf2, x):
    dev = torch.as_tensor(buf2)                        # EXPECT r5-aliasing
    buf2[1] = x
    return dev


def bad_as_tensor_on_a_named_device(buf3, x, device):
    dev = torch.as_tensor(buf3, device=device)         # EXPECT r5-aliasing
    buf3[1] = x
    return dev


def clean_copy_to_the_card(buf4, x):
    dev = torch.as_tensor(buf4, device="cuda")
    buf4[1] = x
    return dev


def clean_copies(buf5, x):
    a = torch.tensor(buf5)
    b = torch.from_numpy(buf5.copy())
    c = torch.from_numpy(buf5).clone()
    buf5[0] = x
    return a, b, c


def clean_mutation_before(n, dead):
    out = np.zeros((n,), np.int32)
    out[: len(dead)] = dead
    return torch.from_numpy(out)


class Holder:
    def seal(self):
        return torch.from_numpy(self._delta[: self._count])  # EXPECT r5-aliasing

    def insert(self, pts):
        self._delta[0:2] = pts

    def suppressed_seal(self):
        return torch.from_numpy(self._delta)  # repro: allow[r5-aliasing] fixture: justified
'''

STALE_ALLOW = '''"""Fixture: a suppression that matches nothing must itself be reported."""


def nothing():
    return 1  # repro: allow[r1-host-sync] stale: there is no finding here
'''


def _expected(mod: Module):
    out = set()
    for lineno, text in enumerate(mod.lines, start=1):
        m = _EXPECT_RE.search(text)
        if m:
            out.add((lineno, m.group(1)))
    return out


def _run_all(mod: Module):
    return {(f.line, f.rule) for f in run_rules(default_rules(), [mod])}


@pytest.mark.parametrize("fixture,pretend", [
    (R1_HOST_SYNC, "repro_torch/serve/engine.py"),
    (R1_TORCH_SINKS, "repro_torch/core/pipeline.py"),
    (R1_NEUTRAL, "repro_torch/kernels/ops.py"),
    (R2_RECOMPILE, "repro_torch/serve/engine.py"),
    (R3_WIRE, "repro_torch/cluster/wal.py"),
    (R4_MUTATION, "repro_torch/cluster/router.py"),
    (R5_ALIASING, "repro_torch/core/segments.py"),
], ids=["r1_host_sync", "r1_torch_sinks", "r1_neutral", "r2_recompile",
        "r3_wire", "r4_mutation", "r5_aliasing"])
def test_fixture_findings_match_expect_tags(fixture, pretend):
    mod = Module(pretend, fixture)
    assert _run_all(mod) == _expected(mod), pretend


def test_rules_do_not_fire_outside_their_scope():
    # the same violating code under a path outside the rule's scope is
    # silent (per-rule applies() gating, exercised through run_rules)
    mod = Module("repro_torch/eval/quality.py", R1_HOST_SYNC)
    findings = run_rules([HostSyncRule()], [mod])
    # the rule itself stays silent; its now-unused suppressions surface
    assert [f for f in findings if f.rule == "r1-host-sync"] == []
    assert {f.rule for f in findings} == {"unused-allow"}
    # and the JAX package's paths are outside every scope of the port's
    jax_path = Module("repro/serve/engine.py", R1_HOST_SYNC)
    assert {f.rule for f in run_rules(default_rules(), [jax_path])} == {
        "unused-allow"}


def test_stale_allow_is_reported():
    mod = Module("repro_torch/core/segments.py", STALE_ALLOW)
    findings = run_rules(default_rules(), [mod])
    assert [f.rule for f in findings] == ["unused-allow"]
    assert findings[0].line == 5


def test_suppression_covers_own_line_and_line_below_only():
    src = (
        "import torch\n"
        "def f(q):\n"
        "    x = torch.sum(q)\n"
        "    # repro: allow[r1-host-sync] covers next line\n"
        "    a = int(x.max())\n"
        "    b = x.min().item()\n"
    )
    mod = Module("repro_torch/serve/engine.py", src)
    findings = run_rules([HostSyncRule()], [mod])
    assert [f.line for f in findings] == [6]    # line 5 suppressed


def test_wildcard_allow_suppresses_any_rule():
    src = (
        "import torch\n"
        "def f(q):\n"
        "    x = torch.sum(q)\n"
        "    return x.cpu().numpy()  # repro: allow[*] fixture\n"
    )
    mod = Module("repro_torch/serve/engine.py", src)
    assert run_rules(default_rules(), [mod]) == []


def test_wire_rule_pins_transport_whitelist_definition():
    # the real transport.py satisfies the structural check ...
    from repro_torch.analysis.engine import default_root
    path = os.path.join(default_root(), "cluster", "transport.py")
    with open(path, "r", encoding="utf-8") as f:
        mod = Module("repro_torch/cluster/transport.py", f.read())
    rule = WireProtocolRule()
    assert [f for f in rule.run(mod) if "WIRE_DTYPES" in f.message] == []
    # ... and a transport.py without WIRE_DTYPES is a finding
    bad = Module("repro_torch/cluster/transport.py",
                 "_DTYPES = [1, 2, 3]\n_DTYPE_CODE = {}\n")
    msgs = [f.message for f in rule.run(bad)]
    assert any("WIRE_DTYPES" in m for m in msgs)
    # the whitelist read from the port's AST is the JAX codec's, in order
    from repro.cluster.transport import WIRE_DTYPES
    assert load_wire_dtypes(path) == WIRE_DTYPES


def test_baseline_roundtrip_and_diff(tmp_path):
    f1 = Finding(rule="r1-host-sync", path="repro_torch/a.py", line=3, col=0,
                 message="m1", symbol="A.f")
    f2 = Finding(rule="r5-aliasing", path="repro_torch/b.py", line=9, col=4,
                 message="m2", symbol="g")
    base_path = str(tmp_path / "base.json")
    write_baseline(base_path, [f1])
    baseline = load_baseline(base_path)
    new, stale = diff_against_baseline([f1, f2], baseline)
    assert new == [f2]
    assert stale == set()
    # line numbers are not part of identity: moving a finding is not "new"
    moved = Finding(rule="r1-host-sync", path="repro_torch/a.py", line=77,
                    col=2, message="m1", symbol="A.f")
    new2, stale2 = diff_against_baseline([moved], baseline)
    assert new2 == []
    # a fixed finding surfaces as a stale baseline entry
    _, stale3 = diff_against_baseline([], baseline)
    assert stale3 == {f1.key()}


def test_missing_baseline_is_empty(tmp_path):
    assert load_baseline(str(tmp_path / "nope.json")) == set()


def _cli(*args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *args],
        capture_output=True, text=True, cwd=cwd, timeout=120,
        env={**os.environ, "PYTHONPATH": SRC})


def test_cli_check_is_clean_on_the_real_tree(tmp_path):
    """The shipped tree + the port's own baseline pass the gate, run from a
    directory that holds no baseline (it is found from the package); every
    allow carries a justification and every baseline entry a note."""
    proc = _cli("--check", "--json", cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    data = json.loads(proc.stdout)
    assert data["new"] == []
    assert data["stale_baseline"] == []
    assert data["sanctioned"], "the port's sanctioned reads are listed"
    for ent in data["sanctioned"]:
        lo, hi = ent["lines"]
        assert lo <= ent["line"] <= hi and ent["how"] in ("allow", "baseline")
    allow = re.compile(r"#\s*repro:\s*allow\[[^\]]*\](.*)$")
    for root, _, files in os.walk(os.path.join(SRC, "repro_torch")):
        for fn in files:
            if fn.endswith(".py"):
                with open(os.path.join(root, fn), encoding="utf-8") as f:
                    for line in f:
                        m = allow.search(line)
                        if m:
                            assert len(m.group(1).strip()) > 10, line
    base = os.path.join(SRC, "repro_torch", "analysis", "baseline.json")
    with open(base, encoding="utf-8") as f:
        entries = json.load(f)["findings"]
    assert all(e["note"] and "TODO" not in e["note"] for e in entries)


def test_dead_code_report_runs_and_sees_spawned_modules():
    proc = _cli("--dead-code", cwd=REPO)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "modules scanned:" in proc.stdout
    # the worker module is only reached via "python -m
    # repro_torch.cluster.worker" string constants, the rank processes run
    # repro_torch.launch.dist_index: neither may be reported dead
    for mod in ("repro_torch.cluster.worker", "repro_torch.launch.dist_index",
                "repro_torch.examples.quickstart"):
        assert re.search(rf"^\s+{re.escape(mod)}(\s|$)", proc.stdout,
                         re.MULTILINE) is None, mod


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from(["sink", "item", "clean"]), min_size=1,
                max_size=12))
def test_r1_counts_random_sink_permutations(kinds):
    """Property: K host-sync sinks interleaved with clean statements at
    random positions produce exactly K findings, wherever they land."""
    lines = ["import torch", "def f(q):", "    x = torch.sum(q)"]
    for j, kind in enumerate(kinds):
        if kind == "sink":
            lines.append(f"    v{j} = int(x.max())")
        elif kind == "item":
            lines.append(f"    v{j} = x.min().item()")
        else:
            lines.append(f"    v{j} = x.shape[0] + x.numel()")
    lines.append("    return x")
    mod = Module("repro_torch/serve/engine.py", "\n".join(lines) + "\n")
    assert len(HostSyncRule().run(mod)) == sum(k != "clean" for k in kinds)


@settings(max_examples=30, deadline=None)
@given(st.lists(st.sampled_from(["mutate", "query", "quiesce"]),
                min_size=1, max_size=8))
def test_r4_linear_dominance_random_sequences(ops):
    """Property: mutator calls before the first _quiesce() are findings,
    everything after it is sanctioned."""
    lines = ["class R:", "    def f(self, recs):"]
    expected = 0
    quiesced = False
    for op in ops:
        if op == "quiesce":
            lines.append("        self._quiesce()")
            quiesced = True
        elif op == "mutate":
            lines.append("        self.rep.log_and_apply(recs)")
            expected += 0 if quiesced else 1
        else:
            lines.append("        self.rep.query(recs)")
    mod = Module("repro_torch/cluster/router.py", "\n".join(lines) + "\n")
    assert len(MutationDisciplineRule().run(mod)) == expected


@settings(max_examples=30, deadline=None)
@given(st.integers(min_value=0, max_value=6), st.booleans())
def test_r5_mutation_order_decides(n_after, mutate_before):
    """Property: only mutations at lines AFTER the from_numpy make a view
    dangerous; any number of mutations before it are fine."""
    lines = ["import numpy as np", "import torch",
             "def f(n, pts):", "    buf = np.empty((n, 4), np.int32)"]
    if mutate_before:
        lines.append("    buf[0] = pts")
    lines.append("    dev = torch.from_numpy(buf)")
    for j in range(n_after):
        lines.append(f"    buf[{j + 1}] = pts")
    lines.append("    return dev")
    mod = Module("repro_torch/core/segments.py", "\n".join(lines) + "\n")
    assert len(AliasingRule().run(mod)) == (1 if n_after else 0)


def test_r2_shape_source_sanctions_derived_values():
    src = (
        "import torch\n"
        "from repro_torch.serve.engine import bucket_for\n"
        "def f(batch, dim):\n"
        "    n = batch.shape[0]\n"
        "    b = bucket_for(n)\n"
        "    pad = torch.zeros((b - n, dim), dtype=torch.int32)\n"
        "    raw = torch.zeros((n, dim), dtype=torch.int32)\n"
        "    return pad, raw\n"
    )
    mod = Module("repro_torch/serve/engine.py", src)
    findings = RecompileHazardRule().run(mod)
    assert [f.line for f in findings] == [7]


# -- against the JAX package's suite ----------------------------------------

def test_r4_same_findings_under_both_suites():
    """The JAX package's router fixture: the same (line, rule) set under
    both suites, each at its own package's path."""
    with open(os.path.join(JAX_FIXTURES, "r4_mutation.py"),
              encoding="utf-8") as f:
        source = f.read()
    jmod = jengine.Module("repro/cluster/router.py", source)
    tmod = Module("repro_torch/cluster/router.py", source)
    want = {(f.line, f.rule)
            for f in jengine.run_rules(jrules.default_rules(), [jmod])}
    got = {(f.line, f.rule) for f in run_rules(default_rules(), [tmod])}
    assert got == want and len(want) == 3


def test_baseline_bytes_equal_across_packages(tmp_path):
    fields = [dict(rule="r1-host-sync", path="repro_torch/serve/engine.py",
                   line=291, col=22, message="copy — synchronously",
                   symbol="AnnServingEngine._run_batch"),
              dict(rule="r5-aliasing", path="repro_torch/core/segments.py",
                   line=9, col=4, message="m2", symbol="")]
    ours, theirs = tmp_path / "ours.json", tmp_path / "theirs.json"
    write_baseline(str(ours), [Finding(**kw) for kw in fields])
    jengine.write_baseline(str(theirs), [jengine.Finding(**kw) for kw in fields])
    assert ours.read_bytes() == theirs.read_bytes()


def test_analysis_imports_neither_torch_nor_jax():
    code = (
        "import sys\n"
        "import repro_torch.analysis.rules, repro_torch.analysis.deadcode\n"
        "import repro_torch.analysis.__main__\n"
        "bad = [m for m in sys.modules\n"
        "       if m.split('.')[0] in ('torch', 'jax', 'jaxlib', 'repro')]\n"
        "print(bad)\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": SRC})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[]"


# -- observed syncs held against the lint -----------------------------------

def test_hold_syncs_against_the_sanctioned_reads():
    """A card run's syncs: the rung pick (allowed on its own line), a host
    helper's read (sanctioned at its call site one frame out), one unlisted
    read inside r1's scope (missed) and one outside it (not the lint's)."""
    sanctioned = [
        {"rule": "r1-host-sync", "path": "repro_torch/core/segments.py",
         "line": 485, "lines": [484, 486]},
        {"rule": "r1-host-sync", "path": "repro_torch/core/segments.py",
         "line": 57, "lines": [57, 57]},
        {"rule": "r1-host-sync", "path": "repro_torch/core/segments.py",
         "line": 413, "lines": [413, 414]},
        {"rule": "r5-aliasing", "path": "repro_torch/serve/engine.py",
         "line": 10, "lines": [10, 10]},
    ]
    stacks = {
        "repro_torch/core/segments.py:485": [
            ("repro_torch/core/segments.py", 485, "query_compact"),
            ("repro_torch/serve/engine.py", 293, "_run_batch")],
        "repro_torch/core/pipeline.py:134": [
            ("repro_torch/core/pipeline.py", 134, "max_bucket_occupancy"),
            ("repro_torch/core/segments.py", 57, "_seg_ctot_cap")],
        "repro_torch/serve/engine.py:10": [
            ("repro_torch/serve/engine.py", 10, "_run_batch")],
        "repro_torch/eval/quality.py:40": [
            ("repro_torch/eval/quality.py", 40, "sweep")],
    }
    missed, unhit = hold_syncs(stacks, sanctioned)
    assert missed == ["repro_torch/serve/engine.py:10"]
    assert unhit == ["repro_torch/core/segments.py:413"]


def test_hold_syncs_sanctions_at_the_innermost_frame():
    """An allow on an outer call does not cover a sync inside the function
    it calls: a read in ``build_index`` with no allow of its own, under the
    allowed ``build_index(...)`` statement of ``_build``, is missed, and
    the outer allow counts as not hit.  Only a frame of a host helper
    (``HOST_FNS``) hands its sync to the caller's line."""
    sanctioned = [
        {"rule": "r1-host-sync", "path": "repro_torch/core/segments.py",
         "line": 180, "lines": [180, 181]},
        {"rule": "r1-host-sync", "path": "repro_torch/core/index.py",
         "line": 173, "lines": [173, 174]},
    ]
    under_outer = [("repro_torch/core/index.py", 140, "build_index"),
                   ("repro_torch/core/segments.py", 180, "_build")]
    missed, unhit = hold_syncs(
        {"repro_torch/core/index.py:140": under_outer}, sanctioned)
    assert missed == ["repro_torch/core/index.py:140"]
    assert unhit == ["repro_torch/core/index.py:173",
                     "repro_torch/core/segments.py:180"]
    own = [("repro_torch/core/index.py", 173, "_occ_histogram"),
           ("repro_torch/core/index.py", 131, "build_index"),
           ("repro_torch/core/segments.py", 180, "_build")]
    missed, unhit = hold_syncs(
        {"repro_torch/core/index.py:173": own}, sanctioned)
    assert missed == [] and unhit == ["repro_torch/core/segments.py:180"]
    helper = [("repro_torch/core/pipeline.py", 134, "max_bucket_occupancy"),
              ("repro_torch/core/index.py", 140, "build_index"),
              ("repro_torch/core/segments.py", 180, "_build")]
    assert hold_syncs({"repro_torch/core/pipeline.py:134": helper},
                      sanctioned)[0] == ["repro_torch/core/pipeline.py:134"]


def test_hold_syncs_on_the_real_tree(tmp_path):
    """Every sanctioned r1 read of the real tree, observed, is held; a sync
    on a line of the engine that no finding covers is missed."""
    data = json.loads(_cli("--json", cwd=str(tmp_path)).stdout)
    r1 = [e for e in data["sanctioned"] if e["rule"] == "r1-host-sync"]
    stacks = {f"{e['path']}:{e['line']}": [(e["path"], e["line"], "f")]
              for e in r1}
    assert hold_syncs(stacks, data["sanctioned"]) == ([], [])
    stacks["repro_torch/serve/engine.py:1"] = [
        ("repro_torch/serve/engine.py", 1, "drain")]
    assert hold_syncs(stacks, data["sanctioned"])[0] == [
        "repro_torch/serve/engine.py:1"]
