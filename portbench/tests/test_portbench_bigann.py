"""The four-card cell ``bigann100m.dist4``: its configuration pinned to
sift50m's, its reader of the distributed index's footprint on hand-built
spans, and the shard-by-shard control, which reads ``correct`` false at the
tiny size."""
import importlib.util
import json

import pytest
import torch

import portbench_tiny as tiny
from portbench.harness import program, spec

CELL = "bigann100m.dist4"
INDEX_METRIC = "index_gib.dist"


def _config(name):
    return json.loads((tiny.ROOT / "portbench" / "configs" / f"{name}.json").read_text())


def test_the_configuration_is_sift50ms_but_for_its_rows_and_shards():
    big, sift = _config("bigann100m"), _config("sift50m")
    changed = {"n": 100_000_000, "num_clusters": 48_828}
    assert big["data"] == {**sift["data"], **changed}
    assert big["data"]["num_clusters"] == big["data"]["n"] // 2048
    assert big["index"] == {**sift["index"], "row_shards": 4}
    assert "merge" not in big["index"]
    assert big["reduced"] == ["n"]


def test_the_cells_cards_are_its_row_shards():
    cell = spec.load_cell(tiny.ROOT, CELL)
    assert cell.chips == program.row_shards(cell.config) == 4
    assert cell.traffic == json.loads(
        (tiny.ROOT / "portbench" / "traffic" / "bulk1024.json").read_text())
    assert [m["name"] for m in cell.per_layer] == [INDEX_METRIC]
    # no host-clock rate or tail until its runs spread under half their bounds
    assert {m["name"] for m in cell.end_to_end} == {"peak_gib", "setup_s"}
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in bench["configs"] if c["name"] == "bigann100m")
    assert entry["reduced"] == _config("bigann100m")["reduced"]


def _query_span(index_bytes=None):
    args = {} if index_bytes is None else {"index_bytes": index_bytes}
    return {"name": "dist_query", "args": args}


def _run(spans):
    return type("Run", (), {"spans": list(spans)})()


def test_the_readers_give_hand_computed_values():
    # 25 M rows x 128 int32, 16 tables of int64 keys, int32 ids and runs
    held = 25_000_000 * 128 * 4 + 16 * 25_000_000 * (8 + 4 + 4)
    run = _run([_query_span(held), {"name": "dist_rerank", "args": {"slots": 7}},
                _query_span(held), {"name": "stage_rerank", "args": {}}])
    assert spec.reader(tiny.ROOT, INDEX_METRIC)(run) == pytest.approx(held / 2 ** 30)


def test_without_dist_ranges_or_spans_the_readers_give_nothing():
    """The benchmark's files over a program whose distributed index sets no
    ``index_bytes`` (the parent of the change that added it), or a run with
    no spans at all (untraced)."""
    read = spec.reader(tiny.ROOT, INDEX_METRIC)
    assert read(_run([_query_span()])) is None
    assert read(_run([{"name": "phase_b_rerank", "args": {"index_bytes": 5}}])) is None
    assert read(_run([])) is None


def test_a_traced_four_rank_run_reads_its_shards_index():
    """On four gloo ranks at the tiny size: rank 0's shard of 1,500 rows x 16
    int32, 4 tables of int64 keys, int32 ids and runs, the (4, 32) int32
    histogram and the (T+1, 2M) int8 template."""
    c = tiny.sharded_cell(4)
    c.per_layer = [{"name": INDEX_METRIC, "unit": "GiB"}]
    res = tiny.run_sharded(c, seconds=1.0, trace=True)
    assert res["correct"] is True
    held = 1500 * 16 * 4 + 4 * 1500 * (8 + 4 + 4) + 4 * 32 * 4 + 21 * 12
    assert res["metrics"][INDEX_METRIC]["value"] == pytest.approx(held / 2 ** 30)


def _control_shards():
    path = tiny.ROOT / "portbench" / "tools" / "control_shards.py"
    module_spec = importlib.util.spec_from_file_location("portbench_control_shards", path)
    module = importlib.util.module_from_spec(module_spec)
    module_spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("seed", [2 ** 31 + 11, 12, 13])
def test_the_shard_by_shard_control_reads_incorrect(seed):
    out = _control_shards().control_checks(tiny.sharded_cell(4), seed, 8, "cpu")
    assert out["shards"] == 4
    assert out["correct"] is False
    assert out["checks"]["mismatched_queries"]["value"] > 0


def test_the_control_in_float32_reads_correct(monkeypatch):
    """The same tool with the configuration's own quantisation reads correct:
    its false comes from the bfloat16 buckets, not from how it draws the
    requests, offsets the ids or merges the shards."""
    tool = _control_shards()
    monkeypatch.setattr(tool, "CONTROL_DTYPE", torch.float32)
    out = tool.control_checks(tiny.sharded_cell(4), 12, 8, "cpu")
    assert out["correct"] is True
    assert out["checks"]["mismatched_queries"] == {"value": 0, "limit": 0}


def test_the_control_merges_as_many_shards_as_the_configuration_declares():
    out = _control_shards().control_checks(tiny.sharded_cell(2), 12, 8, "cpu")
    assert out["shards"] == 2 and out["correct"] is False
