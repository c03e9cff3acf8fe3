"""Every name in BENCHMARK.json has its file, and the harness finds a cell,
a configuration or a metric by its file alone."""
import json
import os
import shutil

import harness
from conftest import BENCH

ROOT = os.path.dirname(BENCH)


def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_every_name_has_its_file():
    b = spec()
    for c in b["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"])), c["file"]
        assert c["file"] == f"benchmark/configs/{c['name']}.json"
    names = {c["name"] for c in b["configs"]}
    for w in b["workloads"]:
        cell = harness.load_cell(w["name"])
        assert cell["config"] == w["config"] and w["config"] in names
        assert cell["traffic"] == w["traffic"]
        assert cell["chips"] == w["chips"] and cell["why"] == w["why"]
        kind = cell["traffic_raw"]["kind"]
        assert os.path.isfile(os.path.join(BENCH, "traffic", f"{kind}.py"))
    readers = harness.metric_readers()
    for m in b["per_layer"]:
        assert m["name"] in readers, m["name"]
        assert readers[m["name"]].UNIT == m["unit"]
        assert set(m["workloads"]) <= {w["name"] for w in b["workloads"]}
    assert set(readers) == {m["name"] for m in b["per_layer"]}
    assert set(harness.workload_names()) == {w["name"] for w in b["workloads"]}


def test_each_cell_has_a_limit_for_each_number_its_check_compares():
    for name in harness.workload_names():
        cell = harness.load_cell(name)
        want = ({"loss_gap", "call_loss_gap", "grad_gap", "change_gap", "change_gap_median"}
                if cell["traffic_raw"]["kind"] == "train_pool"
                else {"network_gap", "answers_off"})
        assert set(cell["limits"]) == want, name


def test_a_new_workload_file_alone_is_picked_up(tmp_path, monkeypatch):
    copy = tmp_path / "benchmark"
    shutil.copytree(BENCH, copy, ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    cell = json.loads((copy / "workloads" / "kd_train.tiny_h_d53.b16.json").read_text())
    cell["why"] = "the same job on another pool"
    (copy / "workloads" / "kd_train.tiny_h_d53.b16_again.json").write_text(json.dumps(cell))
    traffic = json.loads((copy / "traffic" / "pool8_b16_k10.json").read_text())
    traffic["pool"] = 4
    (copy / "traffic" / "pool4_b16_k10.json").write_text(json.dumps(traffic))
    cell["traffic"] = "pool4_b16_k10"
    (copy / "workloads" / "kd_train.tiny_h_d53.pool4.json").write_text(json.dumps(cell))
    monkeypatch.setattr(harness, "HERE", str(copy))
    names = harness.workload_names()
    assert "kd_train.tiny_h_d53.b16_again" in names and "kd_train.tiny_h_d53.pool4" in names
    got = harness.load_cell("kd_train.tiny_h_d53.pool4")
    assert got["traffic_raw"]["pool"] == 4 and got["config_raw"]["name"] == got["config"]
    assert harness.traffic_kind(got).__name__ == "bench_traffic_train_pool"
