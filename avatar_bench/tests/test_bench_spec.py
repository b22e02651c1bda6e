"""The runner finds every part of every cell by name, and BENCHMARK.json
keeps to the contract's shapes."""
import json
import re

import pytest

from avatar_bench import run as bench

SPEC = bench.Spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC.doc["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_parts_found_by_name(cell):
    w = SPEC.workload(cell)
    cfg = SPEC.config(w["config"])
    traffic = SPEC.traffic(w["traffic"])
    assert bench.mode_of(traffic).__name__ == f"avatar_bench.{traffic['mode']}"
    assert cfg["precision"] == "float32" and cfg["tf32"] is False
    assert SPEC.limits(cell)
    e2e = {m["name"] for m in SPEC.end_to_end(cell)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layers = SPEC.per_layer(cell)
    assert layers
    for m in layers:
        assert callable(bench.reader(m["name"]))
        assert m["moves"] in e2e


def test_every_metric_has_a_reader_and_a_cell():
    for m in SPEC.doc["per_layer"]:
        assert callable(bench.reader(m["name"]))
        assert set(m["workloads"]) <= set(CELLS)
    for m in SPEC.doc["end_to_end"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)


def test_unknown_names_raise():
    with pytest.raises(KeyError):
        SPEC.workload("no-such-cell")
    with pytest.raises(KeyError):
        SPEC.config("no-such-config")
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric")


def test_contract_shapes():
    doc = SPEC.doc
    assert set(doc) == {"command", "paths", "run_seconds", "configs", "workloads",
                        "end_to_end", "per_layer"}
    assert doc["paths"] == ["avatar_bench"]
    assert 1 <= doc["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in doc[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in doc["end_to_end"] + doc["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in doc["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layer_names = {}
    for m in doc["per_layer"]:
        assert len(m["layer"]) <= 200 and "\n" not in m["layer"]
        if m["name"].endswith("_roofline.serve") or "roofline" in m["name"]:
            assert m["unit"] == "%"
        layer_names.setdefault(m["layer"], []).append(m["name"])
    for w in doc["workloads"]:
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    for c in doc["configs"]:
        cfg = json.loads((bench.ROOT / c["file"]).read_text())
        assert c["file"].startswith("avatar_bench/") and cfg["name"] == c["name"]
        assert cfg["source"] == c["source"]
