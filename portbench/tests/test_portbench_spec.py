"""BENCHMARK.json against the contract's shape rules, and every cell found
by name, with nothing but new files needed for a new one."""

import json
import os
import re
import shutil

import pytest

from portbench import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "config": {"name", "source", "file", "reduced", "why"},
    "workload": {"name", "config", "traffic", "chips", "why"},
    "e2e": {"name", "unit", "better", "bound", "source"},
    "layer": {"name", "unit", "better", "source", "layer", "moves"},
}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_shape(spec):
    assert set(spec) == KEYS["top"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= spec["run_seconds"] <= 51
    assert isinstance(spec["run_seconds"], int)
    assert spec["command"][:2] == ["python3", "portbench/run.py"]
    for p in spec["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
        assert os.path.isdir(os.path.join(ROOT, p))
    used = {w["config"] for w in spec["workloads"]}
    for c in spec["configs"]:
        assert set(c) == KEYS["config"] and NAME.match(c["name"])
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
        assert _line(c["why"]) and _line(c["source"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not k.endswith(("_dim", "_rank"))
                   for k in c["reduced"])
    pairs = set()
    for w in spec["workloads"]:
        assert set(w) == KEYS["workload"]
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and _line(w["why"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    names += [w["name"] for w in spec["workloads"]]
    names += [c["name"] for c in spec["configs"]]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == KEYS["e2e"]
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in spec["per_layer"]:
        assert set(m) - {"workloads"} == KEYS["layer"]
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m["workloads"]) <= cells
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    for cell in cells:      # setup_s, another end-to-end metric, a layer's
        e, layer = harness.cell_metrics(spec, cell)
        assert "setup_s" in {m["name"] for m in e} and len(e) >= 2
        assert layer


def test_every_cell_resolves(spec):
    for w in spec["workloads"]:
        cell = harness.resolve(w["name"], spec)
        assert cell.name == w["name"] and cell.chips == w["chips"]
        assert hasattr(cell.driver, "Driver") and cell.driver.LIMITS
        e2e, layer = harness.cell_metrics(spec, w["name"])
        assert set(cell.readers) == {m["name"] for m in e2e + layer}
        assert all(callable(r.read) for r in cell.readers.values())


def test_unknown_names_fail(spec):
    with pytest.raises(KeyError, match="unknown workload"):
        harness.resolve("no-such-cell", spec)
    bad = json.loads(json.dumps(spec))
    bad["workloads"][0]["config"] = "no-such-config"
    with pytest.raises(KeyError, match="unknown configuration"):
        harness.resolve(bad["workloads"][0]["name"], bad)
    bad = json.loads(json.dumps(spec))
    bad["workloads"][0]["traffic"] = "no-such-traffic"
    with pytest.raises(FileNotFoundError, match="no-such-traffic"):
        harness.resolve(bad["workloads"][0]["name"], bad)
    bad = json.loads(json.dumps(spec))
    bad["per_layer"].append(dict(bad["per_layer"][0], name="no_such_metric"))
    with pytest.raises(FileNotFoundError, match="no_such_metric"):
        harness.resolve(bad["per_layer"][0]["workloads"][0], bad)


def test_a_cell_adds_with_new_files_only(spec, tmp_path):
    """A new configuration, traffic mix, cell and per-layer metric, found by
    name from new files and entries, with every existing file untouched."""
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    before = {p: p.read_bytes() for p in (tmp_path / "portbench").rglob("*")
              if p.is_file()}
    base = json.loads((tmp_path / "portbench/configs/gov2-group_pfd.json")
                      .read_text())
    (tmp_path / "portbench/configs/clueweb09b-group_pfd.json").write_text(
        json.dumps(dict(base, name="clueweb09b-group_pfd",
                        corpus="clueweb09b", n_docs=50_220_423)))
    (tmp_path / "portbench/traffic/decode_l50.json").write_text(json.dumps(
        {"driver": "list_decode", "lists_per_request": 50, "warmup": 40,
         "check_share": 0.1}))
    (tmp_path / "portbench/metrics/pfd_exception_share.py").write_text(
        "def read(rec):\n    return 3.0\n")
    new = json.loads(json.dumps(spec))
    new["configs"].append({"name": "clueweb09b-group_pfd",
                           "source": "https://lemurproject.org/clueweb09/",
                           "file": "portbench/configs/clueweb09b-group_pfd.json",
                           "reduced": ["n_lists"], "why": "a larger web crawl"})
    new["workloads"].append({"name": "cw-decode50", "config": "clueweb09b-group_pfd",
                             "traffic": "decode_l50", "chips": 1,
                             "why": "50 lists a request on ClueWeb09B"})
    next(m for m in new["end_to_end"] if m["name"] == "decode_rate")[
        "workloads"].append("cw-decode50")
    new["per_layer"].append({"name": "pfd_exception_share", "unit": "%",
                             "better": "lower", "source": "program_counter",
                             "layer": "codec decoders", "moves": "decode_rate",
                             "workloads": ["cw-decode50"]})
    cell = harness.resolve("cw-decode50", new, root=str(tmp_path))
    assert cell.config["n_docs"] == 50_220_423
    assert cell.traffic["lists_per_request"] == 50
    assert cell.readers["pfd_exception_share"].read({}) == 3.0
    assert set(cell.metrics) == {"decode_rate", "setup_s"}
    after = {p: p.read_bytes() for p in before}
    assert after == before
