"""BENCHMARK.json keeps to the benchmark's contract: its shape, names,
units and lengths, and every file it names."""
import json
import re

from conftest import HERE, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_shape_and_names():
    text = (ROOT / "BENCHMARK.json").read_text()
    assert len(text.encode()) <= 64 * 1024
    b = json.loads(text)
    assert set(b) == KEYS
    assert b["paths"] == ["perfbench"] and b["command"][1] == \
        "perfbench/run.py"
    assert 1 <= b["run_seconds"] <= 51
    configs = {c["name"] for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and line(c["source"]) and line(c["why"])
        assert c["file"].startswith("perfbench/")
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert all(NAME.match(k) for k in c["reduced"])
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (HERE / "traffic" / f"{w['traffic']}.json").exists()
        assert (HERE / "limits" / f"{w['name']}.json").exists()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(b["workloads"])
    # four chips only where the cell measures what exists across chips: at
    # most a quarter of the cells, rounded down, and one always
    four = [w for w in b["workloads"] if w["chips"] == 4]
    assert len(four) <= max(1, len(b["workloads"]) // 4)
    cells = {w["name"] for w in b["workloads"]}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and line(m["layer"])
        assert set(m["workloads"]) <= cells
        assert (HERE / "metrics" / f"{m['name']}.py").exists()
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for w in cells:
        reported = [m for m in b["end_to_end"]
                    if w in m.get("workloads", cells)]
        assert len(reported) >= 2
        assert any(w in m["workloads"] for m in b["per_layer"])
