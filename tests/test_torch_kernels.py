"""Port parity, kernels: each kernel's plain-torch version against the JAX
package's oracle (``repro.kernels.ref``) and executors, bit for bit on the
CPU, at the adversarial shapes tests/test_fused_probe.py,
tests/test_fused_rerank.py and tests/test_kernels.py use.  The CUDA kernels
are held against the plain versions in tests/test_torch_cuda.py, on the
card."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref
from repro.kernels.fused_probe import (compact_gather_xla, fused_probe_xla,
                                       probe_extents_xla)
from repro.kernels.fused_rerank import fused_rerank_pallas, fused_rerank_xla
from repro.kernels.topk_merge import topk_merge_pallas
from repro_torch.kernels import fused_probe as tfp
from repro_torch.kernels import fused_rerank as tfr
from repro_torch.kernels import ops
from repro_torch.kernels import topk_merge as ttm
from test_torch_cases import (BIG, MERGE_CASES, PROBE_CASES, RERANK_CASES,
                              RERANK_WRAP_CASES)

torch.set_num_threads(1)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("name", sorted(PROBE_CASES))
def test_fused_probe_plain_matches_jax(name):
    keys, ids, pk, cap, cbucket = PROBE_CASES[name]
    want_i, want_c = ref.fused_probe(jnp.asarray(keys), jnp.asarray(ids),
                                     jnp.asarray(pk), cap, cbucket)
    xla_i, xla_c = fused_probe_xla(jnp.asarray(keys), jnp.asarray(ids),
                                   jnp.asarray(pk), cap, cbucket)
    tk, tpk = _t(keys.astype(np.int64)), _t(pk.astype(np.int64))
    got_i, got_c = tfp.fused_probe_plain(tk, _t(ids), tpk, cap, cbucket)
    for other_i, other_c in ((want_i, want_c), (xla_i, xla_c)):
        _eq(other_i, got_i, "ids")
        _eq(other_c, got_c, "counts")
    # the dispatching wrapper takes the plain path for CPU tensors
    ops_i, ops_c = ops.fused_probe(tk, _t(ids), tpk, cap, cbucket)
    _eq(want_i, ops_i)
    _eq(want_c, ops_c)


@pytest.mark.parametrize("name", ["random", "truncating_cbucket", "uint32_extremes",
                                  "wide_l4_p100", "wide_l8_p200", "truncate_in_chunk",
                                  "skewed_and_empty"])
@pytest.mark.parametrize("c_cap", [1, 3, None])
def test_two_phase_extents_and_tighter_cap(name, c_cap):
    """Phase A at the full cap, gathered at a tighter ``c_cap``, equals the
    JAX pair and the oracle run directly at ``c_cap``; phase A through the
    run-length table equals the JAX package's too."""
    keys, ids, pk, cap, cbucket = PROBE_CASES[name]
    c = cap if c_cap is None else c_cap
    jlo, jocc, jcnt = probe_extents_xla(jnp.asarray(keys), jnp.asarray(pk), cap)
    tk, tpk = _t(keys.astype(np.int64)), _t(pk.astype(np.int64))
    tlo, tocc, tcnt = tfp.probe_extents(tk, tpk, cap)
    for a, b in ((jlo, tlo), (jocc, tocc), (jcnt, tcnt)):
        _eq(a, b)
    occ_from = np.stack([np.searchsorted(row, row, side="right") - np.arange(row.size)
                         for row in keys]).astype(np.int32)
    want_from = probe_extents_xla(jnp.asarray(keys), jnp.asarray(pk), cap,
                                  occ_from=jnp.asarray(occ_from))
    got_from = ops.probe_extents(tk, tpk, cap, occ_from=_t(occ_from))
    for a, b in zip(want_from, got_from):
        _eq(a, b, "extents through occ_from")
    got = tfp.compact_gather(_t(ids), tlo, tocc, pk.shape[2], cbucket, c)
    want = compact_gather_xla(jnp.asarray(ids), jlo, jocc, pk.shape[2], cbucket, c)
    oracle = ref.fused_probe(jnp.asarray(keys), jnp.asarray(ids), jnp.asarray(pk),
                             c, cbucket)
    for w in (want, oracle):
        _eq(w[0], got[0])
        _eq(w[1], got[1])
    via_ops = ops.fused_probe(tk, _t(ids), tpk, c, cbucket, extents=(tlo, tocc))
    _eq(oracle[0], via_ops[0])


# ---------------------------------------------------------------------------
# fused_rerank
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(RERANK_CASES))
def test_fused_rerank_plain_matches_jax(name):
    data, queries, ids, k = RERANK_CASES[name]
    want = ref.fused_rerank(jnp.asarray(data), jnp.asarray(queries),
                            jnp.asarray(ids), k)
    xla = fused_rerank_xla(jnp.asarray(data), jnp.asarray(queries),
                           jnp.asarray(ids), k, chunk=16)
    got = tfr.fused_rerank_plain(_t(data), _t(queries), _t(ids), k, chunk=16)
    via_ops = ops.fused_rerank(_t(data), _t(queries), _t(ids), k, chunk=5)
    for other in (xla, got, via_ops):
        _eq(want[0], other[0], "dists")
        _eq(want[1], other[1], "ids")


@pytest.mark.parametrize("name", sorted(RERANK_WRAP_CASES))
def test_fused_rerank_plain_wrapped_sums(name):
    """An int32 L1 sum that wraps ranks by its wrapped (negative) value, as
    in ``ref.fused_rerank`` and the Pallas kernel.  Not held against
    ``fused_rerank_xla``: its packed int32 key drops the wrapped distance
    (it returns 0 for -1879048192), so it disagrees with the reference
    itself here."""
    data, queries, ids, k = RERANK_WRAP_CASES[name]
    args = [jnp.asarray(x) for x in (data, queries, ids)]
    want = ref.fused_rerank(*args, k)
    pallas = fused_rerank_pallas(*args, k, interpret=True)
    got = tfr.fused_rerank_plain(_t(data), _t(queries), _t(ids), k, chunk=4)
    via_ops = ops.fused_rerank(_t(data), _t(queries), _t(ids), k)
    assert int(np.asarray(want[0])[0, 0]) < 0          # the sum did wrap
    for other in (pallas, got, via_ops):
        _eq(want[0], other[0], "dists")
        _eq(want[1], other[1], "ids")


def test_fused_rerank_empty_inputs():
    q = _t(np.zeros((2, 4), np.int32))
    for data, ids in ((np.zeros((0, 4), np.int32), np.zeros((2, 5), np.int32)),
                      (np.zeros((7, 4), np.int32), np.zeros((2, 0), np.int32))):
        d, i = ops.fused_rerank(_t(data), q, _t(ids), 3)
        assert (d.numpy() == BIG).all() and (i.numpy() == -1).all()


# ---------------------------------------------------------------------------
# topk_merge
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(MERGE_CASES))
def test_topk_merge_plain_matches_jax(name):
    da, ia, db, ib = MERGE_CASES[name]
    args = tuple(jnp.asarray(x) for x in (da, ia, db, ib))
    pallas = topk_merge_pallas(*args, bq=4, interpret=True)
    got = ttm.topk_merge_plain(*(_t(x) for x in (da, ia, db, ib)))
    via_ops = ops.topk_merge(*(_t(x) for x in (da, ia, db, ib)))
    for other in (got, via_ops):
        _eq(pallas[0], other[0], "dists vs pallas")
        _eq(pallas[1], other[1], "ids vs pallas")
    want = ref.topk_merge(*args)
    _eq(want[0], got[0], "dists vs ref")
    if name.startswith("lex") or name in ("tied_ids", "all_invalid"):
        _eq(want[1], got[1], "ids vs ref")


def test_topk_merge_float_dists():
    rng = np.random.default_rng(9)
    da = np.sort(rng.random((3, 6)).astype(np.float32), -1)
    db = np.sort(rng.random((3, 6)).astype(np.float32), -1)
    ia = rng.integers(0, 9, (3, 6)).astype(np.int32)
    ib = rng.integers(0, 9, (3, 6)).astype(np.int32)
    pallas = topk_merge_pallas(*(jnp.asarray(x) for x in (da, ia, db, ib)),
                               interpret=True)
    got = ttm.topk_merge_plain(*(_t(x) for x in (da, ia, db, ib)))
    _eq(pallas[0], got[0])
    _eq(pallas[1], got[1])


def test_launch_counts_from_many_threads():
    """``_build.count`` loses no launch when threads count at once, as the
    cluster router's pool threads do; ``reset_launches`` zeroes every count."""
    import sys
    import threading

    from repro_torch.kernels import _build
    _build.reset_launches()
    threads, per = 8, 20_000
    start = threading.Barrier(threads)

    def work():
        start.wait()
        for _ in range(per):
            _build.count("topk_merge")
            _build.count("fused_rerank", 2)

    pool = [threading.Thread(target=work) for _ in range(threads)]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)                     # switch threads as often as it can
    try:
        for t in pool:
            t.start()
        for t in pool:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(old)
    assert _build.LAUNCHES["topk_merge"] == threads * per
    assert _build.LAUNCHES["fused_rerank"] == 2 * threads * per
    # the count is taken under the build lock (in CPython the GIL alone
    # happens to keep ``+=`` whole; the lock does not rest on that)
    with _build._LOCK:
        late = threading.Thread(target=_build.count, args=("topk_merge",))
        late.start()
        late.join(0.2)
        assert late.is_alive() and _build.LAUNCHES["topk_merge"] == threads * per
    late.join(timeout=60)
    assert not late.is_alive() and _build.LAUNCHES["topk_merge"] == threads * per + 1
    _build.reset_launches()
    assert not any(_build.LAUNCHES.values())
