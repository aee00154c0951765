"""Mean phase_b_rerank span a batch (the segmented index's phase B)."""
from portbench.harness.readers import span_ms


def read(run):
    return span_ms(run, "phase_b_rerank")
