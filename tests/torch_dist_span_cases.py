"""The rank job of ``test_torch_dist_spans.py``: a (4, 1) mesh's build and
each merge's query, answered with tracing off and then on, and once more
under a CPU profiler, with the spans, ranges and bytes sent each produced,
and the shard's index bytes.  Imports no JAX, so that each rank starts
quickly."""
import json
import os
from pathlib import Path

from repro_torch.launch import dist_index as di
from repro_torch.obs import trace as obs_trace


def _spans(directory):
    out = []
    for path in sorted(Path(directory).glob("*.jsonl")):
        out.extend(json.loads(line) for line in path.read_text().splitlines() if line)
    return out


def _traced(directory, fn, *args):
    """``fn(*args)`` with ``REPRO_TRACE=1`` into ``directory`` -> (its
    result, the spans it recorded)."""
    saved = {k: os.environ.get(k) for k in ("REPRO_TRACE", "REPRO_TRACE_DIR")}
    os.environ.update(REPRO_TRACE="1", REPRO_TRACE_DIR=str(directory))
    try:
        out = fn(*args)
        obs_trace.flush()
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    return out, _spans(directory)


def _ranges(fn, *args):
    """``fn(*args)`` under a CPU profiler, tracing off -> each ``repro.*``
    range's name with the name of the innermost range around it (None at
    the top)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn(*args)
    events = [(e.name()[len(obs_trace.RANGE_PREFIX):], e.start_ns(),
               e.start_ns() + e.duration_ns()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith(obs_trace.RANGE_PREFIX)]
    out = []
    for name, a, b in events:
        around = [(b2 - a2, n2) for n2, a2, b2 in events
                  if a2 <= a and b <= b2 and (a2, b2) != (a, b)]
        out.append((name, min(around)[1] if around else None))
    return sorted(out, key=str)


def traced_merges(device, data, queries, cfg, params, root):
    """One rank: the build traced, then for each merge the query untraced,
    traced and profiled -> a record a merge and the build's."""
    os.environ.pop("REPRO_TRACE", None)
    mesh = di.make_mesh((4, 1), ("data", "model"), device)
    build = di.dist_build_fn(cfg, mesh)
    state, build_spans = _traced(Path(root, f"build{mesh.rank}"), build, data, params)
    held = sum(t.numel() * t.element_size()
               for t in (state.dataset, state.sorted_keys, state.sorted_ids, state.occ_from,
                         state.occ_hist, state.template))
    out = {"build": {"spans": build_spans, "sent": build.exchange.sent_bytes,
                     "rank": mesh.rank}, "index_bytes": held}
    for merge in di.MERGES:
        query = di.dist_query_fn(cfg, mesh, merge)
        off = query(state, queries)
        before = query.exchange.sent_bytes
        on, spans = _traced(Path(root, f"{merge}{mesh.rank}"), query, state, queries)
        after = query.exchange.sent_bytes
        ranges = _ranges(query, state, queries)
        out[merge] = {"off": [t.numpy() for t in off], "on": [t.numpy() for t in on],
                      "spans": spans, "before": before, "after": after, "ranges": ranges}
    return out
