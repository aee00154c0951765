"""Runnable walkthroughs of the port, one per JAX package example
(``examples/*.py``), same sizes, configs and printed lines:

  python -m repro_torch.examples.quickstart [--device cpu]
  python -m repro_torch.examples.ann_serving [--device cpu]
  python -m repro_torch.examples.cluster_serving [--device cpu]
  python -m repro_torch.examples.generate [--arch smollm-360m] [--device cpu]
  python -m repro_torch.examples.retrieval_augmented_lm [--device cpu]
  python -m repro_torch.examples.train_smollm [--device cpu]

Each ``main(device=None, params_fn=None)`` runs on the card unless asked for
the CPU, draws its hash parameters from a seed unless ``params_fn(cfg,
dim)`` gives them (the tests bridge the JAX twin's), keeps its dataset spec
in the module constant ``SPEC``, checks its own claims (a failed ``assert``
raises) and returns what it measured, with each step's (d, i) under
``answers``.  The two language-model examples draw their model parameters
from a seed unless ``params_fn(cfg)`` (``generate``) or ``lm_params_fn(cfg)``
(``retrieval_augmented_lm``) gives the tree.  ``train_smollm``'s
``main(device=None, steps, ckpt_dir, resume)`` runs the training launcher
and returns each step's loss.
"""
import argparse

__all__ = ["cli_args", "cli_device"]


def cli_args(description: str, **options):
    """An example's command line: ``--device`` (default: the card) and one
    ``--<name>`` for each option, typed and defaulted by its value."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default=None,
                    help="'cuda' (the default) or 'cpu'")
    for name, default in options.items():
        ap.add_argument(f"--{name.replace('_', '-')}", type=type(default), default=default)
    return ap.parse_args()


def cli_device(description: str):
    """The ``--device`` of an example's command line (default: the card)."""
    return cli_args(description).device
