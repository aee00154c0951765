"""Port parity, L1 distance ops: ``l1_distance_plain`` and
``l1_distance_rows_plain`` against the JAX package's ``ref`` oracles and its
Pallas kernels in interpret mode, on the CPU, for int32, int16, float32 and
bfloat16 inputs, including the m = 300 padding case of the TPU wrapper.
Exact everywhere: the case values are integers, which float32 sums exactly
in any order.  The CUDA kernels are held against the plain versions in
tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref
from repro_torch.kernels import ops as tops
from repro_torch.kernels.l1_distance import (l1_distance_plain,
                                             l1_distance_rows_plain)
from test_torch_cases import L1_CASES, L1_INT_CASES, L1_ROWS_CASES

torch.set_num_threads(1)


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


def _both(arr, dtype):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    return (jnp.asarray(arr).astype(dtype),
            torch.from_numpy(np.ascontiguousarray(arr)).to(getattr(torch, dtype)))


def _np(x):
    """A float32 or int32 result as numpy (bfloat16 never comes out)."""
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _check(jax_fn, ref_fn, plain_fn, ops_fn, queries, other, dtype):
    jq, tq = _both(queries, dtype)
    jx, tx = _both(other, dtype)
    got = plain_fn(tq, tx)
    want_dtype = torch.float32 if dtype in ("float32", "bfloat16") else torch.int32
    assert got.dtype == want_dtype
    _eq(_np(ref_fn(jq, jx)), got.numpy(), "ref")
    if got.numel():         # the Pallas wrappers cannot slice an empty block
        _eq(_np(jax_fn(jq, jx)), got.numpy(), "pallas interpret")
    _eq(ops_fn(tq, tx).numpy(), got.numpy(), "ops dispatch on the CPU")


def _cpu_cases(cases):
    """Each JAX call compiles once per shape and type, so the CPU takes every
    shape in int32, the m = 300 and signed shapes in every type, and the
    integer-only cases (wrapped int32 sums, both loops of the CUDA kernel,
    its tile and stage edges); the card takes every case
    (tests/test_torch_cuda.py)."""
    return sorted(n for n in cases if n.endswith("_int32") or "_m300_" in n
                  or n.startswith("signed_") or n in L1_INT_CASES)


@pytest.mark.parametrize("name", _cpu_cases(L1_CASES))
def test_l1_distance_plain_matches_jax(name):
    queries, points, dtype = L1_CASES[name]
    _check(jops.l1_distance, ref.l1_distance, l1_distance_plain,
           tops.l1_distance, queries, points, dtype)


@pytest.mark.parametrize("name", _cpu_cases(L1_ROWS_CASES))
def test_l1_distance_rows_plain_matches_jax(name):
    queries, rows, dtype = L1_ROWS_CASES[name]
    _check(jops.l1_distance_rows, ref.l1_distance_rows, l1_distance_rows_plain,
           tops.l1_distance_rows, queries, rows, dtype)


def test_l1_non_integer_floats():
    """Non-integer float32 values: the sums agree to rtol 1e-6, because the
    two packages add the m terms in different orders."""
    rng = np.random.default_rng(4)
    q = rng.uniform(-3, 3, (9, 64)).astype(np.float32)
    x = rng.uniform(-3, 3, (40, 64)).astype(np.float32)
    rows = rng.uniform(-3, 3, (9, 21, 64)).astype(np.float32)
    np.testing.assert_allclose(
        l1_distance_plain(torch.from_numpy(q), torch.from_numpy(x)).numpy(),
        np.asarray(ref.l1_distance(jnp.asarray(q), jnp.asarray(x))), rtol=1e-6)
    np.testing.assert_allclose(
        l1_distance_rows_plain(torch.from_numpy(q), torch.from_numpy(rows)).numpy(),
        np.asarray(ref.l1_distance_rows(jnp.asarray(q), jnp.asarray(rows))), rtol=1e-6)


def test_chunking_changes_no_bit(monkeypatch):
    """The plain versions give the same bits at any chunk size."""
    from repro_torch.kernels import l1_distance as tl1
    queries, points, _ = L1_CASES["q130_n257_m100_int32"]
    q, x = torch.from_numpy(queries), torch.from_numpy(points)
    rq, rr, _ = L1_ROWS_CASES["q9_c128_m200_int32"]
    whole = (tl1.l1_distance_plain(q, x),
             tl1.l1_distance_rows_plain(torch.from_numpy(rq), torch.from_numpy(rr)))
    monkeypatch.setattr(tl1, "PLAIN_CHUNK_ELEMS", 1000)
    _eq(whole[0], tl1.l1_distance_plain(q, x))
    _eq(whole[1], tl1.l1_distance_rows_plain(torch.from_numpy(rq), torch.from_numpy(rr)))
