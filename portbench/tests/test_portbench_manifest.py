"""BENCHMARK.json resolves by name: every cell's configuration, traffic and
metric readers; and a configuration, traffic mix or metric added as files
and entries is found with no edit of code."""

import json
import re
import shutil

import pytest
from conftest import ROOT

from portbench import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _manifest():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_manifest_keys_and_names():
    m = _manifest()
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert 1 <= m["run_seconds"] <= 51
    metrics = m["end_to_end"] + m["per_layer"]
    names = [x["name"] for x in metrics + m["workloads"] + m["configs"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for x in metrics:
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
    assert "setup_s" in [x["name"] for x in m["end_to_end"]]
    for x in m["end_to_end"]:
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert x["moves"] in [e["name"] for e in m["end_to_end"]]


@pytest.mark.parametrize("cell", [w["name"] for w in _manifest()["workloads"]])
def test_every_cell_resolves(cell):
    c = manifest.load_cell(cell, ROOT)
    assert c.config["name"] == c.config_name
    assert c.config["reduced"] == []
    for m in c.end_to_end + c.per_layer:
        assert callable(manifest.metric_reader(c, m["name"]))
    assert {"cfg_s", "setup_s"} <= {m["name"] for m in c.end_to_end}
    assert c.per_layer


def _copy(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    return json.loads((tmp_path / "BENCHMARK.json").read_text())


def _save(tmp_path, m):
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))


@pytest.mark.parametrize("kind", ["traffic", "config", "metric"])
def test_added_files_found_without_code_edit(tmp_path, kind):
    m = _copy(tmp_path)
    bench = tmp_path / "portbench"
    cell = dict(m["workloads"][0])
    if kind == "traffic":
        t = json.loads((bench / "traffic" / f"{cell['traffic']}.json")
                       .read_text())
        t["momenta"] = [[0, 0, 0]]
        (bench / "traffic" / "one-momentum.json").write_text(json.dumps(t))
        cell.update(name="wilson32-defl.one-momentum",
                    traffic="one-momentum")
    elif kind == "config":
        c = json.loads((ROOT / m["configs"][0]["file"]).read_text())
        c.update(name="wilson32-defl-k125", kappa=0.125)
        (bench / "configs" / "wilson32-defl-k125.json").write_text(
            json.dumps(c))
        m["configs"].append(dict(m["configs"][0], name="wilson32-defl-k125",
                                 file="portbench/configs/"
                                      "wilson32-defl-k125.json"))
        cell.update(name="wilson32-defl-k125.flagship",
                    config="wilson32-defl-k125")
    else:
        (bench / "metrics" / "configurations.py").write_text(
            "def read(run):\n    return len(run.calls)\n")
        m["per_layer"].append({"name": "configurations", "unit": "count",
                               "better": "higher",
                               "source": "program_counter",
                               "layer": "eigensolver", "moves": "cfg_s"})
    if kind != "metric":
        m["workloads"].append(cell)
    _save(tmp_path, m)
    got = manifest.load_cell(cell["name"], tmp_path)
    if kind == "traffic":
        assert got.traffic["momenta"] == [[0, 0, 0]]
    elif kind == "config":
        assert got.config["kappa"] == 0.125
    else:
        reader = manifest.metric_reader(got, "configurations")

        class Run:
            calls = [1, 2, 3]
        assert reader(Run()) == 3


def test_program_takes_the_traffic():
    from portbench.harness import Program
    c = manifest.load_cell("wilson32-defl.flagship", ROOT)
    p = Program(c.config, c.traffic, "cpu")
    assert [tuple(x) for x in p.loop.momenta] == [(0, 0, 0), (1, 0, 0),
                                                   (0, 1, 1)]
    assert p.loop.disp_entries == ["+z:1"]
    bad = dict(c.traffic, gauge="cold")
    with pytest.raises(ValueError):
        Program(c.config, bad, "cpu")
