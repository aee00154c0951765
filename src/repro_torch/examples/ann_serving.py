"""End-to-end driver (the paper's kind of system): serve batched ANN requests
against a mutable segmented MP-RW-LSH index — live inserts/deletes with
watermark-triggered compaction — plus checkpoint + restart of the node.

  PYTHONPATH=src python -m repro_torch.examples.ann_serving [--device cpu]
"""
import tempfile

import numpy as np
import torch

from repro_torch.ckpt import CheckpointManager
from repro_torch.core.baselines import brute_force_l1, recall
from repro_torch.core.index import IndexConfig
from repro_torch.core.segments import SegmentedIndex
from repro_torch.data import ann_synthetic as ds
from repro_torch.examples import cli_device
from repro_torch.serve.engine import AnnServingEngine, ServeConfig

SPEC = ds.DatasetSpec("serving", n=20000, dim=64, universe=128,
                      num_clusters=32)


def main(device=None, params_fn=None):
    spec = SPEC
    data = ds.make_dataset(spec)
    cfg = IndexConfig(num_tables=8, num_hashes=12, width=56, num_probes=200,
                      candidate_cap=128, universe=spec.universe, k=10)
    engine = AnnServingEngine(
        cfg, ServeConfig(batch_size=64, delta_cap=512, compact_watermark=0.6),
        data, device=device, params_fn=params_fn)
    dev = engine.device
    answers = {}

    # simulate request traffic in uneven bursts
    rng = np.random.default_rng(1)
    for burst in (30, 64, 100, 17):
        engine.submit(ds.make_queries(spec, data, burst, seed=int(rng.integers(1e6))))
        answers[f"burst_{burst}"] = engine.drain()
        print(f"burst of {burst:3d} served; engine stats: {engine.summary()}")

    # quality check on a fresh batch
    q = ds.make_queries(spec, data, 64, seed=9)
    engine.submit(q)
    d, i = answers["quality"] = engine.drain()
    _, ti = brute_force_l1(torch.from_numpy(data).to(dev),
                           torch.from_numpy(q).to(dev), 10)
    r = recall(i, ti.cpu().numpy())
    print("recall@10:", round(r, 4))

    # live mutation: insert fresh points, query them, delete, verify gone
    new_pts = (rng.integers(0, spec.universe // 2, (400, spec.dim)) * 2
               ).astype(np.int32)
    gids = engine.insert(new_pts)          # crosses the watermark -> compacts
    engine.submit(new_pts[:64])
    d, i = answers["inserts"] = engine.drain()
    hit = float((i[:, 0] == gids[:64]).mean())
    print(f"inserted {len(gids)} pts; self-hit@1 on inserts: {hit:.2f}; "
          f"stats: {engine.summary()}")
    assert hit == 1.0

    engine.delete(gids)
    engine.submit(new_pts[:64])
    d, i = answers["deleted"] = engine.drain()
    assert not np.isin(i, gids).any(), "deleted points must never be returned"
    print("deleted inserts; none returned post-delete. "
          f"segments={engine.index.num_segments} "
          f"tombstones={engine.index.num_tombstones}")

    # checkpoint the node (payload = compacted IndexState + gids so every
    # acknowledged insert/delete survives), simulate a crash, restore,
    # re-serve
    payload = engine.checkpoint_payload()
    engine.submit(q)
    d, i = answers["before_restore"] = engine.drain()
    with tempfile.TemporaryDirectory(prefix="repro_serving_ckpt_") as root:
        mgr = CheckpointManager(root, keep=1)
        mgr.save(1, payload)
        r_state, r_gids, r_next = mgr.restore(1, payload, device=dev)
    node = SegmentedIndex.from_checkpoint(cfg, r_state, r_gids, r_next)
    d2, i2 = node.query(torch.from_numpy(q).to(dev))
    d2, i2 = answers["restored"] = d2.cpu().numpy(), i2.cpu().numpy()
    same = bool((d2 == d).all()) and bool((i2 == i).all())
    print("restored-node results identical:", same)
    assert same
    return {"recall": r, "self_hit": hit, "restored_identical": same,
            "gids": gids, "answers": answers}


if __name__ == "__main__":
    main(cli_device(__doc__))
