"""Every file the harness finds by name is there and parses, and
``BENCHMARK.json`` keeps to the shape the harness reads."""

import json
import re

import pytest

from h100_bench import harness

ROOT = harness.HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["per_layer"]]


@pytest.mark.parametrize("cell", CELLS)
def test_each_cell_finds_its_files(cell):
    spec = harness.Spec.load(ROOT, cell)
    assert spec.cfg["name"] == spec.cell["config"]
    assert set(spec.limits) == {"logp_gap", "grad_gap", "mean_z", "sd_gap"}
    assert spec.traffic["engine"] == "nuts" and spec.traffic["chains"] > 0
    assert spec.cfg_path.with_suffix(".py").exists()
    assert (harness.HERE / "reference" / f"{spec.cell['config']}.py").exists()
    assert {m["name"] for m in spec.end_to_end()} >= {"setup_s", "ess_per_s", "fit_s"}
    assert spec.per_layer(), "every cell reports a per-layer metric"
    for m in spec.per_layer():
        moves = m["moves"]
        assert moves in {e["name"] for e in spec.end_to_end()}, (m["name"], moves)


@pytest.mark.parametrize("metric", METRICS)
def test_each_metric_has_a_reader(metric):
    module = harness.load_module(harness.HERE / "metrics" / f"{metric}.py")
    assert callable(module.read)


def test_names_units_and_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("h100_bench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
        assert all(NAME.match(w[k]) for k in ("name", "config", "traffic"))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert set(m["workloads"]) <= set(CELLS)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")


def test_an_engine_other_than_nuts_is_refused():
    spec = harness.Spec.load(ROOT, CELLS[0])
    spec.traffic["engine"] = "chees"
    with pytest.raises(ValueError, match="NUTS fits only"):
        harness.Program(spec, 1, "cpu")
