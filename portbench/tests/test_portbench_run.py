"""``portbench/run.py`` as a benchmark run starts it, without a card."""
import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import portbench_tiny as tiny

ARGS = ["--workload", "sift50m.bulk1024", "--seed", "3", "--seconds", "1", "--trace", "0"]


def _run(root: Path):
    return subprocess.run([sys.executable, "portbench/run.py", *ARGS], cwd=root,
                          capture_output=True, text=True, timeout=120)


def test_without_a_card_it_exits_non_zero_and_prints_no_result():
    if torch.cuda.is_available():
        return                      # a CUDA build with a card runs the cells instead
    got = _run(tiny.ROOT)
    assert got.returncode != 0
    assert got.stdout.strip() == ""
    assert "no CUDA device" in got.stderr


def test_beside_only_its_own_files_it_exits_non_zero(tmp_path):
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(tiny.ROOT / "BENCHMARK.json", tmp_path)
    got = _run(tmp_path)
    assert got.returncode != 0 and got.stdout.strip() == ""


def _on_four_cards(tmp_path: Path, row_shards) -> Path:
    """A copy of the benchmark whose cells ask for four cards, their
    configurations declaring ``row_shards`` (none when None)."""
    shutil.copytree(tiny.ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (tmp_path / "src" / "repro_torch").mkdir(parents=True)
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    bench["workloads"] = [dict(w, chips=4) for w in bench["workloads"]]
    for c in bench["configs"]:
        config = json.loads((tiny.ROOT / c["file"]).read_text())
        if row_shards is not None:
            config["index"]["row_shards"] = row_shards
        (tmp_path / c["file"]).write_text(json.dumps(config))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return tmp_path


def test_a_cell_on_more_than_one_card_is_refused(tmp_path):
    """... when fewer cards are found than it asks for (here none)."""
    got = _run(_on_four_cards(tmp_path, 4))
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert "needs 4 cards, 0 found" in got.stderr


@pytest.mark.parametrize("row_shards", [None, 2])
def test_a_cell_whose_cards_are_not_its_row_shards_is_refused(tmp_path, row_shards):
    got = _run(_on_four_cards(tmp_path, row_shards))
    assert got.returncode != 0 and got.stdout.strip() == ""
    assert f"declares {row_shards or 1} row shards" in got.stderr


def test_benchmark_json_names_files_that_exist():
    bench = json.loads((tiny.ROOT / "BENCHMARK.json").read_text())
    for c in bench["configs"]:
        assert (tiny.ROOT / c["file"]).is_file()
    names = [m["name"] for m in bench["end_to_end"] + bench["per_layer"]]
    for name in names:
        assert (tiny.ROOT / "portbench" / "metrics" / f"{name}.py").is_file()
    for w in bench["workloads"]:
        traffic = json.loads((tiny.ROOT / "portbench" / "traffic" / f"{w['traffic']}.json")
                             .read_text())
        assert (tiny.ROOT / "portbench" / "loops" / f"{traffic['kind']}.py").is_file()
