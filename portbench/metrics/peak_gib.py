"""torch.cuda.max_memory_allocated() over set-up and window, in GiB."""
from portbench.harness.readers import peak_gib as read  # noqa: F401
