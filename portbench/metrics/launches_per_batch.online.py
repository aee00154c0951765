"""Device kernel records a batch in the kept profiled window: torch's
operations and the port's kernels."""
from portbench.harness.readers import kernels_per_batch as read  # noqa: F401
