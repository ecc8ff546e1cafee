"""``BENCHMARK.json`` and the files it names: every cell, configuration,
traffic mix, limits file and per-layer reader is found by name, and the
file keeps to the benchmark's contract."""

import configparser
import math
import os
import re

import pytest

from nerfbench import harness

BENCH = harness.load_json(harness.BENCHMARK)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nerfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert os.path.getsize(harness.BENCHMARK) <= 64 * 1024
    assert all("/" not in w and ".." not in w for w in BENCH["command"][1:])


def test_names_units_and_entries():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    names = ([c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in metrics])
    assert all(NAME.match(n) for n in names)
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        assert len({x["name"] for x in group}) == len(group)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("nerfbench/") and os.path.isfile(
            os.path.join(harness.ROOT, c["file"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(CELLS) // 4)


def test_end_to_end_bounds_and_sources():
    names = {m["name"]: m for m in BENCH["end_to_end"]}
    assert set(names) == {"train_rays_per_s", "frame_s", "setup_s"}
    assert names["setup_s"]["bound"] <= 0.25 and "workloads" not in names["setup_s"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("cell", CELLS)
def test_cell_found_by_name(cell):
    c = harness.load_cell(cell)
    assert c.traffic["kind"] in ("train", "render")
    assert c.limits and all(isinstance(v, (int, float)) for v in c.limits.values())
    module = c.reference()
    for fn in ("init_params", "fields", "param_loss", "lr_scale"):
        assert callable(getattr(module, fn))
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_reader_found_by_name(metric):
    assert set(metric) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    assert metric["source"] in ("device_trace", "program_span", "program_counter",
                                "host_clock")
    assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
    assert callable(harness.metric_reader(metric["name"]).read)
    if metric["name"].endswith("_roofline") or "mfu" in metric["name"]:
        assert metric["unit"] == "%"


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_configuration_is_the_shipped_ini(config):
    """The configuration file holds every key of ``conf/<name>.ini`` at its
    shipped value, and only the program's defaults besides."""
    ini = harness.load_json(os.path.join(harness.ROOT, config["file"]))["ini"]
    parser = configparser.ConfigParser()
    parser.read(os.path.join(harness.ROOT, "conf", config["name"] + ".ini"))
    shipped = {k.upper(): v for k, v in parser[config["name"]].items()}
    from tinynerf_torch.config import Config
    for key, raw in shipped.items():
        if key in harness.PLACE_KEYS or key == "IMG_DIR":
            continue
        value = ini[key]
        if isinstance(value, bool):
            assert raw.strip().lower() in (("true", "1", "yes") if value else ("false", "0", "no"))
        elif isinstance(value, (int, float)):
            assert math.isclose(float(raw), float(value))
        elif isinstance(value, list):
            assert [int(x) for x in raw.strip("[] ").replace(",", " ").split()] == value
        else:
            assert raw.strip() == value
    cfg = harness.program_config(ini, seed=1)
    defaults = Config()
    from tinynerf_torch.config import _KEY_TO_FIELD
    for key in set(ini) - set(shipped):
        assert getattr(cfg, _KEY_TO_FIELD[key]) == getattr(defaults, _KEY_TO_FIELD[key])
