"""Device-idle ms a batch whose gap's middle lies inside one of the
program's ``repro.*`` ranges: the card waiting on the program's own host
work, not on the client between requests (kept profiled window)."""
from portbench.harness.stages import program_idle_ms_per_batch as read  # noqa: F401
