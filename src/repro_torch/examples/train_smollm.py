"""Train a reduced smollm for a few hundred steps with checkpoint/restart,
the twin of the JAX package's ``examples/train_smollm.py``: a thin wrapper
over ``repro_torch.launch.train``.

  PYTHONPATH=src python -m repro_torch.examples.train_smollm [--device cpu]
"""
import os
import tempfile

from repro_torch.examples import cli_device
from repro_torch.launch.train import main as train_main

STEPS = 200
# its own directory, never the JAX twin's
CKPT_DIR = os.path.join(tempfile.gettempdir(), "repro_torch_train_ckpt")


def main(device=None, steps=STEPS, ckpt_dir=CKPT_DIR, resume=True):
    """The reduced smollm-360m, B 8 x S 128, lr 3e-3, a checkpoint every 50
    steps into ``ckpt_dir``, resuming from the newest one there unless
    ``resume`` is false; returns each step's loss."""
    argv = ["--arch", "smollm-360m", "--reduced",
            "--steps", str(steps), "--batch", "8", "--seq", "128",
            "--lr", "3e-3", "--ckpt-dir", ckpt_dir, "--ckpt-every", "50"]
    argv += ["--resume"] if resume else []
    argv += [] if device is None else ["--device", str(device)]
    return train_main(argv)


if __name__ == "__main__":
    main(cli_device(__doc__))
