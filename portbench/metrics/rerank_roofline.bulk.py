"""fused_rerank's share of its roofline: the counted work's least time
over the profiler's rerank device time, in the kept window."""
from portbench.harness.readers import RERANK_KERNELS, rerank_work, roofline


def read(run):
    return roofline(run, RERANK_KERNELS, rerank_work(run))
