"""Find a cell's parts by name: its entry in `BENCHMARK.json`, its
configuration file, its traffic file and its limits file.

A cell names a configuration and a traffic mix.  The configuration's file
is the one `BENCHMARK.json` lists for it; the traffic mix is
`benchmark/traffic/<traffic>.json`, whose `mode` names the module that
drives it, `benchmark/modes/<mode>.py`; the limits of the output check
are `benchmark/limits/<cell>.json`, and each per-layer metric is read by
`benchmark/metrics/<metric>.py`.  Adding a cell adds files and entries;
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import re
from pathlib import Path
from typing import Any, Dict

ROOT = Path(__file__).resolve().parents[1]
PACKAGE = Path(__file__).resolve().parent.name


@dataclasses.dataclass(frozen=True)
class Cell:
    """One workload of `BENCHMARK.json` with everything it names."""
    name: str
    chips: int
    config_name: str
    config: Dict[str, Any]        # the configuration file, whole
    traffic_name: str
    traffic: Dict[str, Any]       # the traffic file
    limits: Dict[str, float]      # number compared -> its limit
    end_to_end: tuple             # this cell's end-to-end metric entries
    per_layer: tuple              # this cell's per-layer metric entries


def load_benchmark(root: Path = ROOT) -> Dict[str, Any]:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _in_cell(metric: Dict[str, Any], cell: str) -> bool:
    return cell in metric.get("workloads", [cell])


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of `BENCHMARK.json`; raises KeyError naming
    what is missing."""
    bench = load_benchmark(root)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    with open(root / configs[w["config"]]["file"]) as f:
        config = json.load(f)
    here = root / PACKAGE
    with open(here / "traffic" / f"{w['traffic']}.json") as f:
        traffic = json.load(f)
    with open(here / "limits" / f"{name}.json") as f:
        limits = json.load(f)["limits"]
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=config, traffic_name=w["traffic"], traffic=traffic,
                limits=limits,
                end_to_end=tuple(m for m in bench["end_to_end"]
                                 if _in_cell(m, name)),
                per_layer=tuple(m for m in bench["per_layer"]
                                if _in_cell(m, name)))


def load_mode(cell: Cell, root: Path = ROOT):
    """The module `benchmark/modes/<mode>.py` of the cell's traffic,
    loaded from its file."""
    mode = cell.traffic["mode"]
    path = root / PACKAGE / "modes" / f"{mode}.py"
    if not re.fullmatch(r"[A-Za-z_][A-Za-z0-9_]*", mode) \
            or not path.is_file():
        raise KeyError(f"traffic {cell.traffic_name!r}: no mode {mode!r}")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_mode_{mode}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _replace(default, values: Dict[str, Any]):
    """``default`` (a dataclass instance) with the fields of ``values``,
    nested dataclasses built the same way and lists made tuples."""
    fields = {}
    for f in dataclasses.fields(default):
        if f.name not in values:
            continue
        cur, new = getattr(default, f.name), values[f.name]
        if dataclasses.is_dataclass(cur):
            fields[f.name] = _replace(cur, new)
        else:
            fields[f.name] = _tuples(new)
    unknown = set(values) - {f.name for f in dataclasses.fields(default)}
    if unknown:
        raise KeyError(f"{type(default).__name__} has no field "
                       f"{sorted(unknown)}")
    return dataclasses.replace(default, **fields)


def _tuples(v):
    return tuple(_tuples(x) for x in v) if isinstance(v, list) else v


def build_config(config_module, values: Dict[str, Any]):
    """The `Config` of ``config_module`` (the port's `mvsdet_torch.config`
    or the reference's copy) holding ``values``, a configuration file's
    `config` object."""
    return _replace(config_module.Config(), values)
