"""The port's two language-model examples (``repro_torch.examples.generate``
and ``retrieval_augmented_lm``) on the CPU, each against its JAX twin's
steps (``examples/generate.py``, ``examples/retrieval_augmented_lm.py``)
with the twin's parameters bridged across."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as jax_reduced
from repro.core import index as jidx
from repro.core.baselines import brute_force_l1 as j_brute
from repro.core.baselines import recall
from repro.data.normalize import fit_normalizer
from repro.models import model as JM
from repro.models import transformer as jtf
from repro_torch import bridge
from repro_torch.examples import generate, retrieval_augmented_lm as rag

torch.set_num_threads(1)
KEY = jax.random.PRNGKey(0)             # the twins' model key
INDEX_KEY = jax.random.PRNGKey(1)       # the retrieval twin's index key


def _lm_params_fn(jparams):
    """A ``params_fn(cfg)`` handing the port the twin's model parameters."""
    tree = jax.tree.map(np.asarray, jparams)
    return lambda cfg: bridge.lm_params_from_numpy(cfg, tree)


@pytest.mark.parametrize("arch", ["smollm-360m", "mamba2-370m"])
def test_generate_equals_the_jax_steps(arch, capsys):
    """The twin's greedy loop (its arch, batch and steps) and the port's
    ``main`` with the same parameters: the same sequence, token for token,
    and the same printed lines."""
    cfg = jax_reduced(arch)
    params = JM.init_params(KEY, cfg)
    steps, batch = generate.STEPS, generate.BATCH
    caches = JM.make_caches(cfg, batch, steps + 8, jnp.float32)
    step = jax.jit(lambda p, c, t, pos: JM.decode_step(p, cfg, c, t, pos))
    tok = jnp.full((batch, 1), 7, jnp.int32)
    out = [tok]
    for i in range(steps):
        logits, caches = step(params, caches, tok, jnp.int32(i))
        tok = jnp.argmax(logits[..., :cfg.vocab], axis=-1).astype(jnp.int32)
        out.append(tok)
    want = np.asarray(jnp.concatenate(out, axis=1))
    printed = [f"arch={cfg.name} generated {want.shape}:"] + [f"  {r.tolist()}" for r in want]

    got = generate.main(device="cpu", arch=arch, params_fn=_lm_params_fn(params))
    np.testing.assert_array_equal(got["sequence"], want)
    assert capsys.readouterr().out.splitlines() == printed


def test_generate_runs_on_its_own_parameters(capsys):
    out = generate.main(device="cpu", steps=6)
    assert out["sequence"].shape == (generate.BATCH, 7) and out["arch"] == "smollm-360m-reduced"
    assert (out["sequence"][:, 0] == 7).all()
    assert capsys.readouterr().out.startswith("arch=smollm-360m-reduced generated (2, 7):")


def _jax_embed(params, cfg, tokens):
    """The twin's ``embed``: mean-pooled final hidden state."""
    x = params["embed"][tokens] * jnp.sqrt(cfg.d_model)
    pos = jnp.broadcast_to(jnp.arange(tokens.shape[1], dtype=jnp.int32)[None], tokens.shape)
    h, _, _ = jtf.decoder_stack(params, cfg, x, positions=pos)
    return h.mean(axis=1)


def test_retrieval_augmented_lm_equals_the_jax_steps(capsys):
    """The twin's steps at its arch and memory size.  The port's embeddings
    with the twin's model parameters within float32 atol = rtol = 1e-4;
    then, from the twin's normalized integers with its hash parameters
    bridged, the index's (d, i) and the brute-force ground truth bit for bit,
    and the printed hit rate and recall equal."""
    cfg = jax_reduced(rag.ARCH)
    params = JM.init_params(KEY, cfg)
    rng = np.random.default_rng(0)
    mem_tokens = rng.integers(1, cfg.vocab, (rag.MEMORY_SIZE, 16)).astype(np.int32)
    embed = jax.jit(lambda t: _jax_embed(params, cfg, t))
    embs = np.asarray(embed(jnp.asarray(mem_tokens)))
    norm = fit_normalizer(embs, target_universe=512)
    mem = norm.apply(embs)
    icfg = jidx.IndexConfig(num_tables=6, num_hashes=10, width=96, num_probes=100,
                            candidate_cap=64, universe=512, k=5)
    state = jidx.build_index(icfg, INDEX_KEY, jnp.asarray(mem))
    q_idx = rng.integers(0, rag.MEMORY_SIZE, 32)
    q_tokens = mem_tokens[q_idx].copy()
    q_tokens[:, -2:] = rng.integers(1, cfg.vocab, (32, 2))
    q_embs = np.asarray(embed(jnp.asarray(q_tokens)))
    q = norm.apply(q_embs)
    d, i = jidx.query_index(icfg, state, jnp.asarray(q))
    hit = float((np.asarray(i[:, 0]) == q_idx).mean())
    td, ti = j_brute(jnp.asarray(mem), jnp.asarray(q), 5)
    r = recall(np.asarray(i), np.asarray(ti))

    out = rag.main(device="cpu", lm_params_fn=_lm_params_fn(params))
    assert capsys.readouterr().out.splitlines()[0] == f"memory embeddings: {embs.shape}"
    np.testing.assert_array_equal(out["q_idx"], q_idx)
    for name, want in (("memory", embs), ("query", q_embs)):
        np.testing.assert_allclose(out["embeddings"][name], want, atol=1e-4, rtol=1e-4)

    p = jidx.make_params(icfg, INDEX_KEY, mem.shape[1])
    got = rag.retrieve(mem, q, q_idx, "cpu", params_fn=lambda cfg, dim: bridge.params_from_numpy(
        p.width, np.asarray(p.offsets), np.asarray(p.mix_a), np.asarray(p.mix_c),
        np.asarray(p.walks.pairs), np.asarray(p.walks.prefix)))
    for name, (wd, wi) in (("query", (d, i)), ("brute_force", (td, ti))):
        np.testing.assert_array_equal(got["answers"][name][0], np.asarray(wd), err_msg=name)
        np.testing.assert_array_equal(got["answers"][name][1], np.asarray(wi), err_msg=name)
    assert got["hit_rate"] == hit and got["recall"] == r
    assert (f"top-1 source-passage hit-rate={got['hit_rate']:.3f} recall@5 vs "
            f"exact-L1={got['recall']:.3f}") == (f"top-1 source-passage hit-rate={hit:.3f} "
                                                 f"recall@5 vs exact-L1={r:.3f}")
