"""Language-model training: AdamW and the train step (the JAX package's
``train/`` in torch)."""
from . import optimizer, train_loop  # noqa: F401
