"""95th percentile of the traced run's request times (paced by the host)."""
from portbench.harness.readers import latency_ms


def read(run):
    return latency_ms(run, 95)
