"""Greedy generation with the decode path (KV/SSM caches), any architecture.

  PYTHONPATH=src python -m repro_torch.examples.generate --arch mamba2-370m \
      --steps 24 [--device cpu]
"""
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_reduced
from repro_torch.examples import cli_args
from repro_torch.models import model as M
from repro_torch.models.transformer import tree_map

ARCH, STEPS, BATCH = "smollm-360m", 24, 2


def main(device=None, arch=ARCH, steps=STEPS, batch=BATCH, params_fn=None):
    """Generate ``steps`` greedy tokens for ``batch`` rows from token 7 with
    the model's reduced config; ``params_fn(cfg)`` gives the parameter tree
    (else drawn from seed 0).  Returns the arch and the (batch, steps + 1)
    sequence."""
    device = resolve_device(device)
    cfg = get_reduced(arch)
    if cfg.kind == "encdec":
        raise SystemExit("use the decoder-only/ssm archs for this example")
    params = (M.init_params(cfg, device=device) if params_fn is None
              else tree_map(lambda t: t.to(device), params_fn(cfg)))
    max_len = steps + 8
    caches = M.make_caches(cfg, batch, max_len, torch.float32, device=device)

    tok = torch.full((batch, 1), 7, dtype=torch.int32, device=device)
    out = [tok]
    with torch.no_grad():
        for i in range(steps):
            logits, caches = M.decode_step(params, cfg, caches, tok, i)
            tok = torch.argmax(logits[..., :cfg.vocab], dim=-1).to(torch.int32)
            out.append(tok)
    seq = torch.cat(out, dim=1).cpu().numpy()  # repro: allow[r1-host-sync] the sequence read once, after the loop, to print it
    print(f"arch={cfg.name} generated {seq.shape}:")
    for row in seq:
        print(" ", row.tolist())
    return {"arch": cfg.name, "sequence": seq}


if __name__ == "__main__":
    args = cli_args(__doc__, arch=ARCH, steps=STEPS, batch=BATCH)
    main(args.device, args.arch, args.steps, args.batch)
