"""Retrieval-augmented LM serving: every assigned architecture can act as the
embedding producer for an MP-RW-LSH memory (kNN-LM style).

Pipeline: prompt -> model hidden state (mean-pooled) -> paper Sect. 3.2
normalization (shift/scale/round-to-even) -> MP-RW-LSH query -> neighbor ids.

  PYTHONPATH=src python -m repro_torch.examples.retrieval_augmented_lm \
      --arch smollm-360m [--device cpu]
"""
import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.core.baselines import brute_force_l1, recall
from repro_torch.core.index import IndexConfig, build_index, query_index
from repro_torch.data.normalize import fit_normalizer
from repro_torch.examples import cli_args
from repro_torch.models import model as M
from repro_torch.models import transformer as tf

ARCH, MEMORY_SIZE = "smollm-360m", 4096
NUM_QUERIES, K = 32, 5
INDEX = IndexConfig(num_tables=6, num_hashes=10, width=96, num_probes=100,
                    candidate_cap=64, universe=512, k=K)
INDEX_SEED = 1


def embed(params, cfg, tokens):
    """Mean-pooled final hidden state as the retrieval embedding (the
    embedding rows times the float32 sqrt(d_model), as the twin scales
    them)."""
    x = params["embed"][tokens] * float(np.sqrt(np.float32(cfg.d_model)))
    pos = tf._positions(tokens.shape[0], tokens.shape[1], tokens.device)
    with torch.no_grad():
        if cfg.kind == "hybrid":
            h, _, _ = tf.hybrid_stack(params, cfg, x, positions=pos)
        elif cfg.kind == "encdec":
            h = tf.encoder_stack(params, cfg, x)  # encoder as embedder
        else:
            h, _, _ = tf.decoder_stack(params, cfg, x, positions=pos)
    return h.mean(dim=1)


def retrieve(mem, q, q_idx, device, params_fn=None):
    """Steps 2-3 on the normalized integers: index ``mem`` with MP-RW-LSH
    (hash parameters from ``params_fn(cfg, dim)``, else seed 1), query
    ``q``, and score against the exact L1 top-k.  Returns the index's
    (d, i), the ground truth's, the top-1 hit rate against ``q_idx`` and
    recall@k, beside what the smoke re-answers (config, state, tensors)."""
    params = None if params_fn is None else params_fn(INDEX, mem.shape[1]).to(device)
    points = torch.from_numpy(mem).to(device)
    state = build_index(INDEX, points, params=params, seed=INDEX_SEED)
    queries = torch.from_numpy(q).to(device)
    d, i = query_index(INDEX, state, queries)
    td, ti = brute_force_l1(points, queries, K)
    d, i, td, ti = (t.cpu().numpy() for t in (d, i, td, ti))
    hit = float((i[:, 0] == q_idx).mean())
    return {"hit_rate": hit, "recall": recall(i, ti),
            "answers": {"query": (d, i), "brute_force": (td, ti)},
            "index": {"cfg": INDEX, "state": state, "points": points, "queries": queries}}


def main(device=None, arch=ARCH, memory_size=MEMORY_SIZE, lm_params_fn=None,
         params_fn=None):
    """The twin's steps with the model's reduced config: ``lm_params_fn(cfg)``
    gives the model's parameter tree (else drawn from seed 0) and
    ``params_fn(cfg, dim)`` the hash parameters.  Returns ``retrieve``'s
    result with both embeddings' arrays under ``embeddings``."""
    device = resolve_device(device)
    cfg = get_reduced(arch)
    params = (M.init_params(cfg, device=device) if lm_params_fn is None
              else tf.tree_map(lambda t: t.to(device), lm_params_fn(cfg)))
    rng = np.random.default_rng(0)

    # 1. Build a "memory" of passage embeddings.
    mem_tokens = rng.integers(1, cfg.vocab, (memory_size, 16)).astype(np.int32)
    embs = embed(params, cfg, torch.from_numpy(mem_tokens).to(device)).cpu().numpy()
    print("memory embeddings:", embs.shape)

    # 2. Normalize to even ints (paper Sect. 3.2).
    norm = fit_normalizer(embs, target_universe=512)
    mem = norm.apply(embs)

    # 3. Queries = perturbed copies of some passages (near-duplicates).
    q_idx = rng.integers(0, memory_size, NUM_QUERIES)
    q_tokens = mem_tokens[q_idx].copy()
    q_tokens[:, -2:] = rng.integers(1, cfg.vocab, (NUM_QUERIES, 2))  # small edit
    q_embs = embed(params, cfg, torch.from_numpy(q_tokens).to(device)).cpu().numpy()
    q = norm.apply(q_embs)

    out = retrieve(mem, q, q_idx, device, params_fn)
    print(f"arch={cfg.name}: top-1 source-passage hit-rate={out['hit_rate']:.3f} "
          f"recall@5 vs exact-L1={out['recall']:.3f}")
    out["embeddings"] = {"memory": embs, "query": q_embs}
    out["q_idx"] = q_idx
    return out


if __name__ == "__main__":
    args = cli_args(__doc__, arch=ARCH, memory_size=MEMORY_SIZE)
    main(args.device, args.arch, args.memory_size)
