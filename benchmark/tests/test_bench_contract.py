"""BENCHMARK.json against the benchmark's contract: names, units, keys,
the files each name points at, and which cells report which metrics."""

import json
import os
import re

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def bench(*parts):
    return os.path.join(ROOT, "benchmark", *parts)


def test_top_level_keys_and_size():
    assert set(SPEC) == KEYS
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len(SPEC["command"]) <= 32
    for word in SPEC["command"]:
        assert TEXT.match(word) and not word.startswith("/")
        assert ".." not in word


@pytest.mark.parametrize("kind", ["configs", "workloads", "end_to_end",
                                  "per_layer"])
def test_names_and_units(kind):
    names = [e["name"] for e in SPEC[kind]]
    assert len(names) == len(set(names))
    for e in SPEC[kind]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert TEXT.match(e[key]), (e["name"], key)


def test_entry_keys():
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_pairs_unique_and_configs_used():
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_every_cell_reports_enough():
    for w in SPEC["workloads"]:
        e2e = [m["name"] for m in SPEC["end_to_end"] if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(m, w["name"]) for m in SPEC["per_layer"])


def test_moves_names_an_end_to_end_metric_of_each_cell():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = [w["name"] for w in SPEC["workloads"]]
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e, m["name"]
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)


def test_every_name_has_its_files():
    for w in SPEC["workloads"]:
        traffic = json.load(open(bench("traffic", w["traffic"] + ".json")))
        assert os.path.exists(bench("entries", traffic["entry"] + ".py"))
        assert os.path.exists(bench("runners", traffic["runner"] + ".py"))
        assert os.path.exists(bench("limits", w["name"] + ".json"))
        config = json.load(open(bench("configs", w["config"] + ".json")))
        assert config["name"] == w["config"]
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert os.path.exists(bench("metrics", m["name"] + ".py")), m["name"]


def test_layers_of_one_name_are_spelled_alike():
    layers = {m["layer"] for m in SPEC["per_layer"]}
    assert all("\n" not in l for l in layers)
    by_prefix = {}
    for m in SPEC["per_layer"]:
        by_prefix.setdefault(m["name"].split(".")[0], set()).add(m["layer"])
    assert all(len(v) == 1 for v in by_prefix.values())


def test_four_chip_cells_within_their_share():
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)


TRAIN_CELLS = [w["name"] for w in SPEC["workloads"] if json.load(open(
    bench("traffic", w["traffic"] + ".json")))["entry"] == "train"]


@pytest.mark.parametrize("cell", TRAIN_CELLS)
def test_a_train_check_covers_the_schedule(cell):
    """The checked steps reach a warmup step below the full rate, the
    warmup's end, and, under a scheduler, a step past the first epoch."""
    import sys

    sys.path.insert(0, ROOT)
    from benchmark import harness, program
    from benchmark.reference import glow as ref

    c = harness.Cell(SPEC, cell, 1, 0, 0, device="cpu")
    opt, spe = c.config["experiment"], program.steps_per_epoch(c)
    steps = range(c.traffic["checked_steps"])
    rates = [ref.lr_at(opt, spe, k) / opt["lr"] for k in steps]
    warm = max(1, opt["warmup_epochs"] * spe)
    assert min(rates) < 1.0 or warm == 1
    assert max(steps) >= warm - 1
    if opt.get("scheduler_name", "None") != "None":
        assert max(steps) // spe >= 1
        assert rates[-1] < max(rates)
