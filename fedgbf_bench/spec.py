"""``BENCHMARK.json`` and the files it names.

Everything that belongs to one configuration, traffic mix or metric sits in
a file of its own, found by the name ``BENCHMARK.json`` gives it:

* a configuration: the ``file`` of its entry (``configs/<name>.json``);
* a traffic mix: ``traffic/<mix>.json``, whose ``kind`` names the driver
  that runs it (``drivers/<kind>.py``);
* a metric: its reader, ``metrics/<name>.py``;
* a cell's comparison limits: ``limits/<cell>.json``.

So a later change adds a configuration, a mix, a metric or a cell as new
files and new entries, without editing a file that is already here.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def load(path: Path | None = None) -> dict:
    with open(path or REPO / "BENCHMARK.json") as f:
        return json.load(f)


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json; have "
                   f"{[w['name'] for w in spec['workloads']]}")


def config(spec: dict, name: str) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def read_json(relpath: str | Path) -> dict:
    with open(REPO / relpath) as f:
        return json.load(f)


def config_data(spec: dict, name: str) -> dict:
    return read_json(config(spec, name)["file"])


def traffic_path(mix: str) -> Path:
    return HERE / "traffic" / f"{mix}.json"


def traffic(mix: str) -> dict:
    return read_json(traffic_path(mix))


def driver_path(kind: str) -> Path:
    return HERE / "drivers" / f"{kind}.py"


def driver(kind: str):
    if not kind.isidentifier():
        raise ValueError(f"bad driver kind {kind!r}")
    return importlib.import_module(f"fedgbf_bench.drivers.{kind}")


def reader_path(metric: str) -> Path:
    return HERE / "metrics" / f"{metric}.py"


def reader(metric: str):
    """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
    path = reader_path(metric)
    mod_name = "fedgbf_bench_metric_" + re.sub(r"\W", "_", metric)
    loader = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(loader)
    loader.loader.exec_module(module)
    return module.read


def limits_path(cell_name: str) -> Path:
    return HERE / "limits" / f"{cell_name}.json"


def limits(cell_name: str) -> dict:
    """``{number: limit}`` of a cell's comparison."""
    with open(limits_path(cell_name)) as f:
        return {k: float(v["limit"]) for k, v in json.load(f).items()}


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(spec: dict, cell_name: str) -> list:
    return [m for m in spec["end_to_end"] if _applies(m, cell_name)]


def per_layer(spec: dict, cell_name: str) -> list:
    reported = {m["name"] for m in end_to_end(spec, cell_name)}
    return [m for m in spec["per_layer"]
            if _applies(m, cell_name) and m["moves"] in reported]


def problems(spec: dict) -> list:
    """What in ``spec`` breaks the benchmark's rules or names a file that
    is not there; empty when all is well."""
    out = []
    names = [c["name"] for c in spec["configs"]]
    cells = [w["name"] for w in spec["workloads"]]
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    for kind, seq in (("configuration", names), ("cell", cells),
                      ("metric", metrics)):
        if len(set(seq)) != len(seq):
            out.append(f"two {kind}s share a name")
    for n in names + cells + metrics:
        if not NAME.match(n):
            out.append(f"bad name {n!r}")
    for c in spec["configs"]:
        if not (REPO / c["file"]).is_file():
            out.append(f"configuration {c['name']}: no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"bad reduced key {key!r}")
    pairs = set()
    for w in spec["workloads"]:
        if w["config"] not in names:
            out.append(f"cell {w['name']}: unknown config {w['config']!r}")
        if not NAME.match(w["traffic"]):
            out.append(f"cell {w['name']}: bad traffic name")
        elif not traffic_path(w["traffic"]).is_file():
            out.append(f"cell {w['name']}: no traffic file")
        else:
            kind = traffic(w["traffic"])["kind"]
            if not driver_path(kind).is_file():
                out.append(f"cell {w['name']}: no driver {kind!r}")
        if not limits_path(w["name"]).is_file():
            out.append(f"cell {w['name']}: no limits file")
        if w["chips"] not in (1, 4):
            out.append(f"cell {w['name']}: chips must be 1 or 4")
        if (w["config"], w["traffic"]) in pairs:
            out.append(f"cell {w['name']}: configuration and traffic repeat")
        pairs.add((w["config"], w["traffic"]))
    e2e = {m["name"] for m in spec["end_to_end"]}
    if "setup_s" not in e2e:
        out.append("no setup_s")
    for m in spec["end_to_end"] + spec["per_layer"]:
        if not UNIT.match(m["unit"]):
            out.append(f"metric {m['name']}: bad unit {m['unit']!r}")
        if m["better"] not in ("lower", "higher"):
            out.append(f"metric {m['name']}: better must be lower or higher")
        if m["source"] not in SOURCES:
            out.append(f"metric {m['name']}: unknown source")
        if not reader_path(m["name"]).is_file():
            out.append(f"metric {m['name']}: no reader file")
        for w in m.get("workloads", []):
            if w not in cells:
                out.append(f"metric {m['name']}: unknown cell {w!r}")
    for m in spec["end_to_end"]:
        if m["source"] not in ("host_clock", "device_trace"):
            out.append(f"metric {m['name']}: end-to-end source")
    for m in spec["per_layer"]:
        if m["moves"] not in e2e:
            out.append(f"metric {m['name']}: moves no end-to-end metric")
            continue
        for w in m.get("workloads", cells):
            if m["moves"] not in {x["name"] for x in end_to_end(spec, w)}:
                out.append(f"metric {m['name']}: cell {w} does not report "
                           f"{m['moves']}")
    for w in cells:
        reported = [m["name"] for m in end_to_end(spec, w)]
        if "setup_s" not in reported or len(reported) < 2:
            out.append(f"cell {w}: needs setup_s and another end-to-end "
                       "metric")
        if not per_layer(spec, w):
            out.append(f"cell {w}: reports no per-layer metric")
    return out
