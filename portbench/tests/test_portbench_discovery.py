"""A configuration, a traffic mix and a metric are files found by name: a
new cell adds files (and its entries in BENCHMARK.json) and edits none."""
import hashlib
import json
import shutil
import time

import portbench_tiny as tiny
from portbench.harness import cell as cell_run
from portbench.harness import spec


def _digests(root):
    return {p.relative_to(root): hashlib.sha1(p.read_bytes()).hexdigest()
            for p in sorted((root / "portbench").rglob("*")) if p.is_file()
            and "__pycache__" not in p.parts}


def test_new_files_make_a_new_cell(tmp_path):
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    before = _digests(tmp_path)

    (tmp_path / "portbench/configs/tinyset.json").write_text(json.dumps(tiny.CONFIG))
    traffic = dict(tiny.TRAFFIC, serve={"batch_size": 16, "bucket_min": 16})
    (tmp_path / "portbench/traffic/burst16.json").write_text(json.dumps(traffic))
    (tmp_path / "portbench/metrics/p50_ms.py").write_text(
        "from portbench.harness.readers import latency_ms\n\n\n"
        "def read(run):\n    return latency_ms(run, 50)\n")
    bench = json.loads((tmp_path / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tinyset", "source": "a test", "reduced": [],
                             "file": "portbench/configs/tinyset.json", "why": "a test"})
    bench["workloads"].append({"name": "tinyset.burst16", "config": "tinyset",
                               "traffic": "burst16", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "p50_ms", "unit": "ms", "better": "lower",
                                "bound": 0.05, "source": "host_clock",
                                "workloads": ["tinyset.burst16"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))

    cell = spec.load_cell(tmp_path, "tinyset.burst16")
    assert cell.config == tiny.CONFIG and cell.traffic == traffic
    assert {m["name"] for m in cell.end_to_end} == {"p50_ms", "peak_gib", "setup_s"}
    res = cell_run.run(cell, 21, 0.3, False, "cpu", time.perf_counter(), lambda m: None)
    assert res["correct"] is True
    assert res["metrics"]["p50_ms"]["value"] > 0
    assert res["attempted"] >= 1

    after = _digests(tmp_path)
    assert {k: v for k, v in after.items() if k in before} == before


def test_a_metric_file_counts_its_own_work_from_the_run(tmp_path):
    """A new per-layer metric reads the run's inputs, the reference's tables
    and the kept window's batches, with no file of the harness edited."""
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "portbench/metrics/hashed_rows.py").write_text(
        "def read(run):\n"
        "    if not run.kept_batches:\n"
        "        return None\n"
        "    dim = run.inputs['points'].shape[1]\n"
        "    assert run.tables.keys.shape[1] == run.inputs['points'].shape[0]\n"
        "    return sum(b.shape[0] for b in run.kept_batches) * dim\n")
    cell = spec.Cell("tiny.cell", 1, tiny.CONFIG, tiny.TRAFFIC, tiny.E2E,
                     [{"name": "hashed_rows", "unit": "values"}], tmp_path)
    res = cell_run.run(cell, 22, 0.6, True, "cpu", time.perf_counter(), lambda m: None)
    assert res["correct"] is True
    batches = res["metrics"]["hashed_rows"]["value"] / tiny.CONFIG["data"]["dim"]
    assert batches > 0 and batches % tiny.TRAFFIC["serve"]["batch_size"] == 0


def test_an_unknown_workload_names_the_known_ones():
    try:
        spec.load_cell(tiny.ROOT, "nosuch.cell")
    except KeyError as err:
        assert "sift50m.bulk1024" in str(err)
    else:
        raise AssertionError("an unknown workload was accepted")
