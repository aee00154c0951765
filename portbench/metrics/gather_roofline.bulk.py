"""The probe gather's share of its roofline: the counted work's least time
over the profiler's gather device time, in the kept window."""
from portbench.harness import workcount
from portbench.harness.readers import GATHER_KERNELS, roofline


def read(run):
    return roofline(run, GATHER_KERNELS, workcount.gather_work)
