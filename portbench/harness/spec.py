"""Finding a cell's parts by name: the benchmark's definition
(BENCHMARK.json at the checkout's root), the cell's file
(portbench/workloads/<cell>.json), its configuration's file (the `file` that
BENCHMARK.json names), its traffic mix (portbench/traffic/<traffic>.json),
its driver (portbench/drivers/<driver>.py) and each metric's reader
(portbench/metrics/<metric>.py). Adding any of them takes new files only;
nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def bench_dir(root: Path) -> Path:
    return Path(root) / "portbench"


def load_benchmark(root: Path = ROOT) -> dict:
    return json.loads((Path(root) / "BENCHMARK.json").read_text())


def read_data(path: Path) -> dict:
    """A JSON data file as a dict."""
    return json.loads(Path(path).read_text())


def find_data(root: Path, folder: str, name: str) -> Path:
    """portbench/<folder>/<name>.json."""
    path = bench_dir(root) / folder / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"{folder}/{name}: no data file {path}")
    return path


def load_module(path: Path, name: str):
    """A Python file loaded by its path (a metric's reader, a driver)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list  # BENCHMARK.json's entries this cell reports
    per_layer: list
    root: Path

    def driver(self):
        path = bench_dir(self.root) / "drivers" / f"{self.traffic['driver']}.py"
        return load_module(path, f"portbench_driver_{self.traffic['driver']}")

    def metric(self, name: str):
        return load_module(bench_dir(self.root) / "metrics" / f"{name}.py",
                           "portbench_metric_" + name.replace(".", "_"))


def _reports(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


def load_cell(name: str, root: Path = ROOT, bench: dict | None = None) -> Cell:
    """The cell `name` of BENCHMARK.json with its files; its workload file
    must agree with BENCHMARK.json on the configuration, traffic and chips."""
    bench = bench or load_benchmark(root)
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"({', '.join(w['name'] for w in bench['workloads'])})")
    own = read_data(find_data(root, "workloads", name))
    for key in ("config", "traffic", "chips"):
        if own.get(key) != entry[key]:
            raise ValueError(f"workloads/{name}: {key} is {own.get(key)!r}, BENCHMARK.json says "
                             f"{entry[key]!r}")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = read_data(Path(root) / cfg_entry["file"])
    traffic = read_data(find_data(root, "traffic", entry["traffic"]))
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"] if m["moves"] in reported and _reports(m, name)]
    return Cell(name=name, chips=entry["chips"], config=config, traffic=traffic,
                limits=own.get("limits", {}), end_to_end=e2e, per_layer=per_layer,
                root=Path(root))
