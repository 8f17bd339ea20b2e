"""``BENCHMARK.json`` through the harness's own loader: every name resolves
to its file, names and units keep to their characters, and every per-layer
metric's cells report the end-to-end metric it moves."""

import re

import pytest

from fedgbf_bench import spec

SPEC = spec.load()


def test_no_problems():
    assert spec.problems(SPEC) == []


def test_names_and_units():
    name = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
    unit = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
    for entry in SPEC["configs"] + SPEC["workloads"]:
        assert name.match(entry["name"])
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert name.match(m["name"]) and unit.match(m["unit"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_cell_resolves(cell):
    w = spec.cell(SPEC, cell)
    assert spec.config_data(SPEC, w["config"])["dataset"]
    traffic = spec.traffic(w["traffic"])
    assert spec.driver(traffic["kind"]).run
    assert spec.limits(cell)
    for m in spec.end_to_end(SPEC, cell) + spec.per_layer(SPEC, cell):
        assert callable(spec.reader(m["name"]))
    reported = {m["name"] for m in spec.end_to_end(SPEC, cell)}
    assert "setup_s" in reported and len(reported) >= 2
    for m in spec.per_layer(SPEC, cell):
        assert m["moves"] in reported
    assert spec.per_layer(SPEC, cell)


def test_per_layer_cells_report_what_they_move():
    for m in SPEC["per_layer"]:
        for cell in m.get("workloads", []):
            assert m["moves"] in {e["name"] for e in
                                  spec.end_to_end(SPEC, cell)}


def test_a_broken_spec_is_caught():
    broken = {**SPEC, "per_layer": SPEC["per_layer"] + [
        {"name": "bad name", "unit": "tokens per s", "better": "lower",
         "source": "host_clock", "layer": "x", "moves": "serve_rows_per_s",
         "workloads": ["credit.train.local"]}]}
    found = " ".join(spec.problems(broken))
    assert "bad name" in found and "bad unit" in found
    assert "does not report serve_rows_per_s" in found
