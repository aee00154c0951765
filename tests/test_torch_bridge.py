"""The bridge of hash parameters from the JAX package to the port: a test of
``repro_torch.bridge`` for every family, and the parameter source the
quality parity tests hand to ``repro_torch.eval.QualityRun(params_fn=...)``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import baselines as jbl
from repro.core import index as jidx
from repro_torch import bridge


def bridged(jparams):
    """The port's ``LshParams`` holding the JAX ``LshParams``' numbers."""
    leaves = [np.asarray(x) for x in (jparams.offsets, jparams.mix_a, jparams.mix_c)]
    if jparams.family == "rw":
        return bridge.params_from_numpy(jparams.width, *leaves,
                                        np.asarray(jparams.walks.pairs),
                                        np.asarray(jparams.walks.prefix))
    return bridge.params_from_numpy(jparams.width, *leaves, family=jparams.family,
                                    proj=np.asarray(jparams.proj))


def params_source(key):
    """``params_fn(cfg, dim)``: the parameters ``repro``'s ``QualityRun``
    draws for ``cfg`` from ``key`` (cached per configuration)."""
    cache = {}

    def params_fn(cfg, dim):
        jcfg = jidx.IndexConfig(**dataclasses.asdict(cfg))
        if (jcfg, dim) not in cache:
            cache[jcfg, dim] = bridged(jidx.make_params(jcfg, key, dim))
        return cache[jcfg, dim]

    return params_fn


def srs_projection(key, data, num_proj):
    """The projection ``repro``'s ``QualityRun.eval_srs`` draws."""
    srs = jbl.build_srs(jax.random.fold_in(key, 1), jnp.asarray(data), num_proj)
    return torch.from_numpy(np.array(srs.proj))


@pytest.mark.parametrize("family", ["rw", "cauchy", "gaussian"])
def test_bridged_params_keep_every_leaf(family):
    """The bridge carries every leaf, so both packages fingerprint one
    parameter set alike, on either device argument."""
    from repro.core import hashes as jh
    from repro_torch.core import hashes as th
    cfg = jidx.IndexConfig(num_tables=3, num_hashes=5, width=24, universe=32,
                           family=family)
    jp = jidx.make_params(cfg, jax.random.PRNGKey(7), 6)
    tp = bridged(jp)
    assert tp.family == family and tp.width == jp.width
    assert th.params_fingerprint(tp) == jh.params_fingerprint(jp)
    assert th.params_fingerprint(tp.to("cpu")) == th.params_fingerprint(tp)
    assert (tp.walks is None) == (family != "rw")
    assert (tp.proj is None) == (family == "rw")
    np.testing.assert_array_equal(tp.mix_a.numpy(), np.asarray(jp.mix_a).astype(np.int64))
