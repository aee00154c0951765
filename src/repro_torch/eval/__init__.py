"""Quality evaluation, torch counterpart of ``repro.eval``.

  * ``quality`` — :class:`QualityRun`: every scheme over one shared exact
    ground truth, ``num_tables`` x ``num_probes`` sweeps, recall@k and
    overall ratio, the "tables needed to reach recall R" statistic, and the
    segmented and compacted cross-layer oracles;
  * ``autotune`` — :func:`tune_for_recall`: the paper's success model
    inverted into (num_tables, num_probes, candidate_cap) for a target
    recall, validated on a calibration split (``ServeConfig.target_recall``).
"""
from .autotune import AutotuneResult, predicted_recall, tune_for_recall
from .quality import SCHEMES, QualityRun, QualitySpec, tables_needed

__all__ = ["SCHEMES", "QualityRun", "QualitySpec", "tables_needed",
           "AutotuneResult", "predicted_recall", "tune_for_recall"]
