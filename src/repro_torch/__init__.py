"""MP-RW-LSH in PyTorch, with hand-written CUDA kernels for Hopper (sm_90a).

The port of the JAX package ``repro``; it imports ``torch`` and numpy and
nothing of ``jax`` or ``repro``.  Layout mirrors the JAX package:

  core/     hashing (RW, Cauchy and Gaussian families), multi-probe
            template and success model, index build, staged query
            pipeline (fused or staged probe), segmented mutable index,
            baselines (brute force, SRS, scheme configs)
  kernels/  the six kernels: fused_probe (as two launches, extents and
            gather), fused_rerank and topk_merge of the serving path,
            rw_hash of ``hash_impl='pallas'`` (as two launches, the
            prefix table and the row-tile hash), and the
            l1_distance and l1_distance_rows ops; a CUDA source under
            ``csrc/`` and a plain-torch version of the same function each;
            ``ops`` dispatches by the tensors' device
  serve/    the batched serving engine (with a recall target, tuned at
            start-up)
  cluster/  the cluster: S shards x R replicas behind a router, each
            replica an engine with a write-ahead log and snapshots, hedged
            re-issue, kill and recovery; in this process or one worker
            process a replica over the JAX package's RPC wire protocol
            (unix sockets with shared-memory slabs, or tcp)
  ckpt/     the checkpoint manager (the JAX package's on-disk layout)
  eval/     the quality protocol (``QualityRun``: recall sweeps over every
            scheme, tables needed, cross-layer oracles) and the recall
            autotuner (``tune_for_recall``)
  obs/      metrics registry, latency histogram, flight recorder and
            ``REPRO_TRACE`` spans (``python -m repro_torch.obs render``)
  analysis/ the lint suite (``python -m repro_torch.analysis``: five rules
            in torch vocabulary, the dead-code report) and the
            ``REPRO_SANITIZE`` race sanitizer
  models/   the language-model substrate (ten architectures) over
            parameter trees, ``configs/`` their numbers; ``sharding``, the
            per-(config, mesh) specs and their DTensor placements
  train/    AdamW and the train step (gradients by ``torch.autograd``)
  examples/ ``quickstart``, ``ann_serving``, ``cluster_serving``,
            ``generate``, ``retrieval_augmented_lm`` and ``train_smollm``
            (``python -m repro_torch.examples.<name>``)
  data/     seeded synthetic datasets, the synthetic LM token stream and
            the even-integer normalizer (numpy, same bits as ``repro``)
  launch/   ``python -m repro_torch.launch.serve``,
            ``python -m repro_torch.launch.cluster_serve``,
            ``python -m repro_torch.launch.train``, the
            distributed index (``dist_index``: row shards and query blocks
            over rank processes on ``torch.distributed``), the production
            meshes (``mesh``) and ``python -m repro_torch.launch.dryrun``
            (one step of every cell traced on fake tensors on a rank of a
            fake 256- or 512-rank world; ``roofline``, its terms on one
            H100)

Entry points run on the card unless the caller asks for the CPU
(``device="cpu"``); with no card they raise.  The package itself imports
torch only when a device is resolved, so that ``repro_torch.analysis``
runs where torch is not installed.
"""
from __future__ import annotations

__all__ = ["resolve_device"]


def resolve_device(device=None) -> "torch.device":
    """``None`` means the card.  A CUDA device without a card raises."""
    import torch
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain-torch path on the CPU")
    return dev
