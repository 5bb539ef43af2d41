"""BENCHMARK.json and the files it names: allowed characters, every
configuration, traffic mix and per-layer reader found by name."""

import json
import re

import pytest

from slambench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MAN = harness.manifest()


def test_top_level_keys():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert 1 <= MAN["run_seconds"] <= 51
    assert any(m["name"] == "setup_s" for m in MAN["end_to_end"])


@pytest.mark.parametrize("m", MAN["end_to_end"] + MAN["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_names_and_units(m):
    keys = {"name", "unit", "better", "source"}
    keys |= {"bound"} if "bound" in m else {"layer", "moves"}
    assert set(m) - {"workloads"} == keys
    assert NAME.match(m["name"]) and UNIT.match(m["unit"])
    assert m["better"] in ("lower", "higher")
    if "bound" in m:
        assert 0.01 <= m["bound"] <= 0.25


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_cells_resolve(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for key in ("name", "config", "traffic"):
        assert NAME.match(w[key])
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    spec = harness.cell_spec(MAN, w["name"])
    assert spec["config"]["name"] == w["config"]
    assert spec["traffic"]["warmup_frames"] > 0
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("m", MAN["per_layer"], ids=lambda m: m["name"])
def test_reader_found_by_name(m):
    assert callable(harness.load_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in MAN["end_to_end"]}


@pytest.mark.parametrize("c", MAN["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    cfg = json.loads((harness.ROOT / c["file"]).read_text())
    assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    assert cfg["settings"]["runtime"]["drop_frames_when_busy"] is False
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    for key in ("source", "why"):
        assert 1 <= len(c[key]) <= 200 and not re.search(r"[\n\t]", c[key])
