"""A configuration, a traffic mix and a per-layer metric added as files
and manifest entries alone are found by their names; the harness's own
look-ups."""

import json
import os
import shutil
import time

import pytest

from perfbench import harness
from perfbench.tests.tiny import make_root


def test_new_files_are_found_by_name(tmp_path):
    root = make_root(str(tmp_path))
    bench = os.path.join(root, "perfbench")
    with open(os.path.join(bench, "configs", "lightgcn_gowalla.json")) as fin:
        cfg = json.load(fin)
    cfg.update(name="dummy_conf")
    cfg["hyper"]["n_layers"] = 2
    with open(os.path.join(bench, "configs", "dummy_conf.json"), "w") as fout:
        json.dump(cfg, fout)
    with open(os.path.join(bench, "traffic", "eval.json")) as fin:
        traffic = json.load(fin)
    traffic.update(warm_calls=1)
    with open(os.path.join(bench, "traffic", "dummy_traffic.json"), "w") as fout:
        json.dump(traffic, fout)
    shutil.copy(os.path.join(bench, "limits", "lightgcn_gowalla.eval.json"),
                os.path.join(bench, "limits", "dummy_conf.dummy_traffic.json"))
    with open(os.path.join(bench, "layer_metrics", "dummy_metric.py"), "w") as fout:
        fout.write('def read(rec):\n    return 2.0 * rec["untraced"]["units"]\n')
    with open(os.path.join(root, "BENCHMARK.json")) as fin:
        manifest = json.load(fin)
    manifest["configs"].append({"name": "dummy_conf", "source": "https://arxiv.org/abs/2002.02126",
                                "file": "perfbench/configs/dummy_conf.json", "reduced": [], "why": "a test"})
    manifest["workloads"].append({"name": "dummy_conf.dummy_traffic", "config": "dummy_conf",
                                  "traffic": "dummy_traffic", "chips": 1, "why": "a test"})
    manifest["end_to_end"][[m["name"] for m in manifest["end_to_end"]].index("eval_users_per_s")][
        "workloads"].append("dummy_conf.dummy_traffic")
    manifest["per_layer"].append({"name": "dummy_metric", "unit": "%", "better": "higher", "source": "host_clock",
                                  "layer": "device", "moves": "eval_users_per_s",
                                  "workloads": ["dummy_conf.dummy_traffic"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as fout:
        json.dump(manifest, fout)

    cell = harness.load_cell(root, "dummy_conf.dummy_traffic")
    assert cell.config["hyper"]["n_layers"] == 2 and cell.traffic["warm_calls"] == 1
    assert [m["name"] for m in cell.per_layer] == ["dummy_metric"]
    assert [m["name"] for m in cell.end_to_end] == ["setup_s", "eval_users_per_s"]
    assert harness.layer_reader(root, "dummy_metric")({"untraced": {"units": 3}}) == 6.0
    # a metric of one quantity in another kind of cell shares its file
    assert harness.layer_reader(root, "dummy_metric.train")({"untraced": {"units": 4}}) == 8.0
    line = harness.run_cell(root, "dummy_conf.dummy_traffic", 5, 0.05, False, "cpu", time.perf_counter())
    assert line["correct"] and "eval_users_per_s" in line["metrics"]


def test_every_manifest_metric_has_a_reader_and_every_cell_its_files():
    root = harness.ROOT
    with open(os.path.join(root, "BENCHMARK.json")) as fin:
        manifest = json.load(fin)
    for m in manifest["per_layer"]:
        assert callable(harness.layer_reader(root, m["name"]))
    for w in manifest["workloads"]:
        cell = harness.load_cell(root, w["name"])
        assert cell.per_layer and len(cell.end_to_end) >= 2
        assert harness.job(cell.traffic["kind"]).run


def test_the_limits_name_the_numbers_compared():
    assert list(harness.judged({"a": 1.0, "b": 2.0}, {"a": 1.0})) == ["a"]
    with pytest.raises(KeyError):
        harness.judged({"a": 1.0}, {"a": 1.0, "c": 2.0})
    assert not harness.is_correct(harness.judged({"a": float("nan")}, {"a": 1.0}))
