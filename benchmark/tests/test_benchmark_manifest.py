"""BENCHMARK.json against the contract it is written to, and the
configuration files against the configurations they copy."""

import dataclasses
import json
import os
import re
import warnings

import pytest

from benchmark import harness as H

MAN = H.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./\-]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}


def _line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_command_and_paths():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert all(_line(w) for w in MAN["command"])
    assert 1 <= len(MAN["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in MAN["paths"])
    assert isinstance(MAN["run_seconds"], int) and 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN).encode()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_are_unique_and_well_formed(section):
    names = [e["name"] for e in MAN[section]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)


def test_metrics_units_sources_and_directions():
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for m in MAN["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in MAN["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in MAN["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])


def test_every_metric_names_cells_that_report_what_it_moves():
    cells = {w["name"] for w in MAN["workloads"]}
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert set(m.get("workloads", [])) <= cells, m["name"]
    for m in MAN["per_layer"]:
        for cell in m["workloads"]:
            e2e, _ = H.cell_metrics(MAN, cell)
            assert m["moves"] in {e["name"] for e in e2e}, (m["name"], cell)
    for cell in cells:
        e2e, layer = H.cell_metrics(MAN, cell)
        names = {e["name"] for e in e2e}
        assert "setup_s" in names and len(names) >= 2 and layer, cell


def test_every_configuration_keeps_a_cell_and_every_cell_one_chip():
    used = {w["config"] for w in MAN["workloads"]}
    assert {c["name"] for c in MAN["configs"]} == used
    pairs = [(w["config"], w["traffic"]) for w in MAN["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["traffic"]) and NAME.match(w["config"])


def test_configuration_entries_and_files():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and c["reduced"] == []
        assert c["file"].startswith("benchmark/configs/") and os.path.exists(os.path.join(H.ROOT, c["file"]))
        body = H.load_json(os.path.join(H.ROOT, c["file"]))
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]


def test_every_named_file_exists():
    for w in MAN["workloads"]:
        tr = H.traffic_file(w["traffic"])
        assert os.path.exists(os.path.join(H.BENCH_DIR, "drivers", tr["driver"] + ".py"))
        assert tr["limits"]
    for m in MAN["per_layer"]:
        assert callable(H.load_metric(m["name"]).read)


def _fields(cfg):
    return H.map_config_fields(cfg)


def test_anymal_deployed_is_the_repository_core_param_yaml():
    pytest.importorskip("yaml")
    from elevation_mapping_cupy_torch import MapConfig
    from elevation_mapping_cupy_torch.config import load_config_with_extras

    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want, extras = load_config_with_extras(os.path.join(H.ROOT, "configs", "core_param.yaml"))
    body = H.config_file(MAN, "anymal_deployed")
    assert MapConfig(**_fields(body)) == want
    assert body["extras"] == extras
    assert body["weights"] == {"file": "elevation_mapping_cupy_torch/data/traversability_weights.npz"}


def test_datagen_default_is_bench_maps_config():
    from elevation_mapping_cupy_torch import MapConfig

    body = H.config_file(MAN, "datagen_default")
    assert MapConfig(**_fields(body)) == MapConfig(max_points=100000)
    assert dataclasses.asdict(MapConfig(**_fields(body))) == dataclasses.asdict(MapConfig(max_points=100000))
    assert body["weights"] == {"zeros": True}
    assert {"batch", "points_per_map", "episode_steps"} <= set(body["assumed"])
