"""Quality evaluation, torch counterpart of ``repro.eval`` (the quality
protocol; the recall autotuner is not ported yet).

  * ``quality`` — :class:`QualityRun`: every scheme over one shared exact
    ground truth, ``num_tables`` x ``num_probes`` sweeps, recall@k and
    overall ratio, the "tables needed to reach recall R" statistic, and the
    segmented and compacted cross-layer oracles.
"""
from .quality import SCHEMES, QualityRun, QualitySpec, tables_needed

__all__ = ["SCHEMES", "QualityRun", "QualitySpec", "tables_needed"]
