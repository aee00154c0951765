"""Device ms a batch of the records launched under the program's
``repro.stage_tombstone`` range (phase B's tombstone mask), in the kept
profiled window."""
from portbench.harness.stages import device_ms_per_batch


def read(run):
    return device_ms_per_batch(run, "stage_tombstone")
