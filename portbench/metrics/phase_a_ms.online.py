"""Mean phase_a span a batch (the segmented index's phase A)."""
from portbench.harness.readers import span_ms


def read(run):
    return span_ms(run, "phase_a")
