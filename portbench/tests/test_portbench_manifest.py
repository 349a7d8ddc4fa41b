"""The manifest: names, units, files found by name, and what each cell
reports."""

import json
import re

import pytest

from harness import manifest, readers

MAN = manifest.load()
CELLS = [w["name"] for w in MAN["workloads"]]


def test_nothing_breaks_the_naming_rules_or_misses_its_file():
    assert manifest.problems(MAN) == []


def test_keys_and_units():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                        "per_layer"}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"]), m["name"]
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}
    assert len(json.dumps(MAN)) < 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_reports_set_up_another_end_to_end_metric_and_a_layer(cell):
    e2e = {m["name"] for m in manifest.end_to_end(MAN, cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = manifest.per_layer(MAN, cell)
    assert layers and all(m["moves"] in e2e for m in layers)
    assert manifest.cell(MAN, cell)["chips"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_has_its_limits_and_a_known_traffic_kind(cell):
    from harness import drivers

    w = manifest.cell(MAN, cell)
    assert manifest.traffic(w["traffic"])["kind"] in drivers.KINDS
    assert all(v > 0 for v in manifest.limits(cell).values())


@pytest.mark.parametrize("name", [m["name"] for m in MAN["per_layer"]])
def test_every_reader_loads(name):
    assert callable(readers.load(name))


@pytest.mark.parametrize("name", [c["name"] for c in MAN["configs"]])
def test_configs_state_their_source_and_cuts(name):
    entry = next(c for c in MAN["configs"] if c["name"] == name)
    cfg = manifest.config(MAN, name)
    assert cfg["source"] == entry["source"] and cfg["reduced"] == entry["reduced"]
    assert cfg["hidden_layer_dim"] == 256 and cfg["last_hidden_layer_dim"] == 128
    assert cfg["scene"]["n_images"] == 71 and cfg["scene"]["size"] == 256
