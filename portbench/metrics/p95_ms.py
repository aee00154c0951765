"""95th percentile of the window's request times, host clock."""
from portbench.harness.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
