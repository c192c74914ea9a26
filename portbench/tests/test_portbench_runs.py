"""Whole runs of the cells at a CPU size: sound runs come out correct; a
run with the program broken underneath, and each cell's control, come
out not correct; the last line's keys; the exits without a card or
without a program; no module of JAX or of the JAX package loaded."""

import ast
import dataclasses
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench import control, harness
from tiny import tiny_cell, tiny_run

CELLS = ("gov2pfd-decode",)
ROOT = harness.ROOT


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = tiny_run(name)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] > 0
    assert list(out)[-1] == "checks"
    assert {"setup_s"} < set(out["metrics"])


# ---- the program broken underneath ---------------------------------------- #


def _break_decoder(monkeypatch, fault):
    from repro_torch.core import codec as codec_lib
    real_get = codec_lib.get
    last = []

    def broken(spec):
        real = spec.torch.vec

        def vec(**kw):
            out = real(**kw)
            if fault == "stale":
                out, last[:] = (last[0] if last else out), [out]
            elif fault == "half":
                out = out[:out.numel() // 2]
            elif fault == "altered":
                out = out.clone()
                out[0] += 1
            return out
        return dataclasses.replace(spec, torch=dataclasses.replace(
            spec.torch, vec=vec))

    monkeypatch.setattr(codec_lib, "get", lambda name: broken(real_get(name)))


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    _break_decoder(monkeypatch, fault)
    out = tiny_run(name)
    assert out["correct"] is False and out["failed"] > 0


def test_a_missing_output_is_wrong():
    """An output the program never gave for a list of the request is
    checked, and counted wrong, not left out of the check."""
    cell = tiny_cell("gov2pfd-decode")
    from portbench import corpus as corpus_lib
    corp = corpus_lib.make_corpus(cell.config, 7)
    drv = cell.driver.Driver(cell.config, cell.traffic, torch.device("cpu"),
                             lambda msg: None)
    drv.setup(corp)
    request = [3, 1, 2, 0]
    outs = drv.serve(request)[:2]           # half of the request left out
    kept = drv.keep(request, outs, None, 0.0, whole=True)
    got = drv.check(corp, kept)
    assert got["lists_wrong"] == 2 and got["postings_wrong"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control (the decode without its exceptions) fails the cell's
    check on three seeds."""
    cell = tiny_cell(name)
    for seed in (3, 4, 2**31 + 5):
        got = control.control(cell, seed, 4, torch.device("cpu"))
        assert got["failed"], got


# ---- the run's ends --------------------------------------------------------- #


def test_result_line():
    run = harness.load_module(os.path.join(ROOT, "portbench", "run.py"))
    line, notes = run.result_line(tiny_run("gov2pfd-decode"),
                                  "card, 700.00 W")
    out = json.loads(line)
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "host", "card", "checks"]
    assert {"corpus_s", "probe_ms_before", "probe_ms_after"} <= set(out["host"])
    assert all(set(m) == {"value", "unit"} for m in out["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    assert notes[0] == "correct: True"
    checked = out["checks"]["postings_checked"]["value"]
    assert notes[1:] == ["check postings_wrong: 0 (at most 0)",
                         "check lists_wrong: 0 (at most 0)",
                         f"check postings_checked: {checked} (at least 1)"]


def _cli(cwd, *args):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "portbench/run.py", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=120)


def test_no_card_no_result():
    p = _cli(ROOT, "--workload", "gov2pfd-decode", "--seed", "1", "--seconds", "1",
             "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""
    assert "cuda" in p.stderr


def test_no_program_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "portbench"), tmp_path / "portbench")
    p = _cli(tmp_path, "--workload", "gov2pfd-decode", "--seed", "1", "--seconds",
             "1", "--trace", "0")
    assert p.returncode == 2 and p.stdout == ""
    assert "no program" in p.stderr


# ---- what a run loads ------------------------------------------------------- #


def _imports(path: str) -> set:
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_sources_import_no_jax():
    bench = os.path.join(ROOT, "portbench")
    for dirpath, _, files in os.walk(bench):
        if os.path.basename(dirpath) == "tests":
            continue
        for f in files:
            if f.endswith(".py"):
                got = _imports(os.path.join(dirpath, f))
                assert not got & harness.FORBIDDEN, (f, got)
                if os.path.basename(dirpath) == "reference":
                    assert "repro_torch" not in got, f


def test_a_run_loads_no_jax():
    """A whole run in a fresh interpreter leaves no module of JAX, the JAX
    package (``repro``, compared whole) or its benchmarks loaded."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "sys.path.insert(0, %r)\n"
            "from tiny import tiny_run\n"
            "from portbench import harness\n"
            "assert tiny_run('gov2pfd-decode')['correct']\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & harness.FORBIDDEN), 'repro_torch' in tops)\n"
            % (ROOT, os.path.join(ROOT, "src"),
               os.path.join(ROOT, "portbench", "tests")))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-2] == "[] True"
