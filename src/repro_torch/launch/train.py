"""End-to-end training launcher, the JAX package's ``launch/train.py`` in
torch: the same flags plus ``--device`` (default: the card).

Trains a config (``--reduced`` for its cut-down twin) on the synthetic LM
stream with AdamW, checkpointing ``(params, opt_state)`` through
``repro_torch.ckpt`` (the JAX package's leaf paths and layout) and resuming
from the newest checkpoint with ``--resume``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-360m --reduced \
      --steps 200 --batch 8 --seq 128 --ckpt-dir /tmp/ckpt --resume [--device cpu]
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.ckpt import CheckpointManager
from repro_torch.configs import get_config, get_reduced
from repro_torch.data.lm_synthetic import LmDataConfig, batch_at_step
from repro_torch.models import model as model_lib
from repro_torch.models.transformer import tree_leaves
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None, help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    opt_cfg = OptConfig(lr=args.lr, moment_dtype=cfg.opt_moment_dtype,
                        warmup_steps=20)
    data_cfg = LmDataConfig(vocab=cfg.vocab, global_batch=args.batch,
                            seq_len=args.seq)

    params = model_lib.init_params(cfg, generator=torch.Generator().manual_seed(0),
                                   device=device)
    opt_state = init_opt_state(params, opt_cfg)
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params/1e6:.1f}M")

    step_fn = make_train_step(cfg, opt_cfg, args.microbatches)
    start = 0
    mgr = None
    if args.ckpt_dir:
        mgr = CheckpointManager(args.ckpt_dir, keep=2)
        if args.resume and mgr.latest_step() is not None:
            start, (params, opt_state) = mgr.restore_latest((params, opt_state),
                                                            device=device)
            print(f"resumed from step {start}")

    losses = []
    t0 = time.perf_counter()
    for step in range(start, args.steps):
        tokens, labels = batch_at_step(data_cfg, step)
        batch = {"tokens": torch.from_numpy(tokens).to(device),
                 "labels": torch.from_numpy(labels).to(device)}
        if cfg.frontend or cfg.kind == "encdec":
            batch["frontend"] = torch.zeros((args.batch, cfg.frontend_len, cfg.d_model),
                                            dtype=getattr(torch, cfg.dtype), device=device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            dt = time.perf_counter() - t0
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {float(metrics['grad_norm']):.3f} "
                  f"({dt / max(step - start + 1, 1):.2f}s/step)")
        if mgr and (step + 1) % args.ckpt_every == 0:
            mgr.save(step + 1, (params, opt_state), blocking=False)
    if mgr:
        mgr.save(args.steps, (params, opt_state))
        mgr.wait()
    first = np.mean(losses[:10])
    last = np.mean(losses[-10:])
    print(f"loss first10={first:.4f} last10={last:.4f} "
          f"improved={'yes' if last < first else 'NO'}")
    return losses


if __name__ == "__main__":
    main()
