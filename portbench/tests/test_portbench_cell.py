"""A whole run of a tiny cell on the CPU: the port's plain versions serve
the requests and the plain reference judges them."""
import json

import portbench_tiny as tiny


def test_untraced_run_is_correct_and_reports_its_metrics():
    lines = []
    res = tiny.run(lines=lines)
    assert res["correct"] is True
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"qps", "p95_ms", "setup_s"}   # no peak on the CPU
    assert list(res)[-1] == "checks"
    assert res["checks"] == {"mismatched_queries": {"value": 0, "limit": 0}}
    assert lines[-1] == "check mismatched_queries: 0 (limit 0)"
    json.dumps(res)


def test_traced_run_reads_spans_and_the_profile():
    res = tiny.run(trace=True, seconds=0.6)
    assert res["correct"] is True
    assert {"phase_a_ms.online", "phase_b_ms.bulk", "p95_ms.online"} <= set(res["metrics"])
    # no device on the CPU: nothing to read for the device metrics
    assert "idle_share.bulk" not in res["metrics"]
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
