"""BENCHMARK.json and the files it names: a cell's configuration, its traffic
mix and the reader of each metric, found by name.

    <bench>/configs/<config>.json   (the manifest's ``file``)
    <bench>/traffic/<traffic>.json
    <bench>/metrics/<metric>.py     (``read(run) -> float | None``)

<bench> is the manifest's first path, under the checkout's root.
"""

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path


@dataclass
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic: dict
    end_to_end: list       # the metric entries this cell reports
    per_layer: list
    bench: Path            # the benchmark's folder


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: Path) -> Cell:
    """The workload `name` of root/BENCHMARK.json with its files read."""
    manifest = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in manifest["workloads"]}
    if name not in cells:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                         f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = json.loads((root / configs[w["config"]]["file"]).read_text())
    bench = root / manifest["paths"][0]
    traffic = json.loads((bench / "traffic" / f"{w['traffic']}.json")
                         .read_text())
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic=traffic,
                end_to_end=[m for m in manifest["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in manifest["per_layer"]
                           if _applies(m, name)], bench=bench)


def metric_reader(cell: Cell, name: str):
    """The ``read`` function of <bench>/metrics/<name>.py."""
    path = cell.bench / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
