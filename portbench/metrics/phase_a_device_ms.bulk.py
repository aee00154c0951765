"""Device ms a batch of the records launched under the program's
``repro.phase_a`` range or below it (phase A's kernels and torch ops), in
the kept profiled window."""
from portbench.harness.stages import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, "phase_a")
