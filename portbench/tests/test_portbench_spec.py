"""The benchmark's data loads by name, agrees with BENCHMARK.json and keeps
to the contract's limits; a cell that lives only in a fixture loads and
runs without an edit to any file of the harness."""

import json
import re

import pytest
import torch

from portbench import run, spec

BENCH = spec.benchmark()
FIXTURE = spec.HERE / "tests" / "fixture"


def test_every_cell_config_mix_and_metric_loads_by_name():
    for w in BENCH["workloads"]:
        c = spec.cell(w["name"])
        assert (c["config"], c["traffic"], c["chips"], c["why"]) == (
            w["config"], w["traffic"], w["chips"], w["why"])
        assert spec.mix(c["traffic"])["kind"] in ("train", "serve")
        assert spec.config(c["config"])["name"] == c["config"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(spec.metric_reader(m["name"]).read)


def test_configs_state_their_source_and_cuts():
    for c in BENCH["configs"]:
        data = json.loads((spec.ROOT / c["file"]).read_text())
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] == []
        assert c["file"].startswith("portbench/")


def test_names_units_and_limits_keep_to_the_contract():
    assert spec.check_names(BENCH) is None
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert re.fullmatch(r"[A-Za-z0-9_/%.\-]{1,16}", m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_each_per_layer_metric_moves_an_end_to_end_metric_its_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    layers = {}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in cells and w in moved.get("workloads", cells)
        layers.setdefault(m["layer"], set()).add(m["name"])
    for w in cells:
        assert len(spec.metrics_of(BENCH, w, False)) >= 2
        assert spec.metrics_of(BENCH, w, True)


def test_a_cell_that_only_a_fixture_holds_runs_on_the_cpu():
    bench = {"end_to_end": [{"name": "serve_tokens_per_s", "unit": "tokens/s"},
                            {"name": "setup_s", "unit": "s"}], "per_layer": []}
    result, _ = run.execute("tiny.backlog", 5, 2.0, False, torch.device("cpu"),
                            bench=bench, base=FIXTURE)
    assert result["correct"], result["check"]
    assert set(result["metrics"]) == {"serve_tokens_per_s", "setup_s"}
    assert list(result)[-1] == "check"


def test_a_part_of_a_quantity_without_a_file_takes_the_quantity_s_reader():
    assert spec.metric_reader("decode_step_ms.burst").__file__.endswith("decode_step_ms.py")
    assert spec.metric_reader("mfu.train").__file__.endswith("mfu.train.py")
    with pytest.raises(FileNotFoundError):
        spec.metric_reader("no_such_quantity.part")


def test_an_unknown_name_is_refused():
    with pytest.raises(FileNotFoundError):
        spec.cell("no-such.cell")
    with pytest.raises(ValueError):
        spec.mix("../traffic/chat-open")
