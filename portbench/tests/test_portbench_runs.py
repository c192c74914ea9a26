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

CELLS = ("gov2pfd-decode", "gov2-stream", "dsv2lite-decode-conv")
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


def _break_stream(monkeypatch, fault):
    from repro_torch.kernels import ops
    real, last = ops.unpack_delta_stream, []

    def unpack(packed, bw, n):
        out = real(packed, bw, n)
        if fault == "stale":
            out, last[:] = (last[0] if last else out), [out]
        elif fault == "half":
            out = out[:out.numel() // 2]
        elif fault == "altered":
            out = out.clone()
            out[-1] += 1
        return out

    monkeypatch.setattr(ops, "unpack_delta_stream", unpack)


def _break_lm(monkeypatch, fault):
    """A decode step that gives back its last logits (its state left as it
    was), that serves half of the batch, or whose logits are altered where
    they are made: one token raised above every other in each row, so
    every session is served it."""
    from repro_torch.models import transformer
    real, last = transformer.decode_step, []

    def step(model, cache, token, pos):
        if fault == "half":
            half = token.shape[0] // 2 or 1
            out, _ = real(model, {k: v[:, :half] for k, v in cache.items()},
                          token[:half], pos)
            return out, cache
        out, cache = real(model, cache, token, pos)
        if fault == "stale":
            out, last[:] = (last[0] if last else out), [out]
        elif fault == "altered":
            out = out.clone()
            out[:, 7] = out.amax(-1) + 1.0
        return out, cache

    monkeypatch.setattr(transformer, "decode_step", step)


BREAK = {"gov2pfd-decode": _break_decoder, "gov2-stream": _break_stream,
         "dsv2lite-decode-conv": _break_lm}


@pytest.mark.parametrize("fault", ["stale", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_program_is_not_correct(monkeypatch, name, fault):
    BREAK[name](monkeypatch, fault)
    out = tiny_run(name)
    assert out["correct"] is False and out["failed"] > 0


def test_one_session_served_wrong_is_not_correct(monkeypatch):
    """One session of the batch served wrong (its logits scaled by 1.5, so
    its tokens stay the same) moves neither of the rows' pooled quantiles,
    and its own median fails ``worst_session_err_p50``."""
    from repro_torch.models import transformer
    real = transformer.decode_step

    def step(model, cache, token, pos):
        out, cache = real(model, cache, token, pos)
        out = out.clone()
        out[3] *= 1.5
        return out, cache

    monkeypatch.setattr(transformer, "decode_step", step)
    out = tiny_run("dsv2lite-decode-conv")
    checks = out["checks"]
    assert out["correct"] is False and out["failed"] > 0
    worst = checks["worst_session_err_p50"]
    assert worst["value"] > worst["at_most"]
    for k in ("logit_err_p50", "token_gap_p90"):
        assert checks[k]["value"] <= checks[k]["at_most"], k


def test_a_missing_output_is_wrong():
    """An output the program never gave for a list of the request is
    checked, and counted wrong, not left out of the check."""
    cell = tiny_cell("gov2pfd-decode")
    from portbench import corpus as corpus_lib
    corp = corpus_lib.make_corpus(cell.config, 7)
    drv = cell.driver.Driver(cell.config, cell.traffic, torch.device("cpu"),
                             lambda msg: None, 7)
    drv.setup(corp)
    request = [3, 1, 2, 0]
    outs = drv.serve(request)[:2]           # half of the request left out
    kept = drv.keep(request, outs, None, 0.0, whole=True)
    got = drv.check(corp, kept)
    assert got["lists_wrong"] == 2 and got["postings_wrong"] > 0


# what the decode cell read at PR 28, before the harness took cells without
# a corpus: the corpus's digest, the window's first three requests', and
# the control's numbers over four requests (seed: corpus, requests, numbers)
DECODE_AT_PR28 = {
    7: ("75e3eae95a7114f3", "d0c158b192b64e8f",
        {"postings_wrong": 5296, "lists_wrong": 102,
         "postings_checked": 115385}),
    2**31 + 5: ("ad33115fc0200d51", "7c0534a174877965",
                {"postings_wrong": 6464, "lists_wrong": 103,
                 "postings_checked": 132203}),
}


@pytest.mark.parametrize("seed", sorted(DECODE_AT_PR28))
def test_the_decode_cell_reads_what_it_read(seed):
    """The corpus, the window's stream, the sample kept and the check's
    numbers of ``gov2pfd-decode`` are those of PR 28's harness, on a sound
    program and on the control."""
    import hashlib
    from portbench import generator
    corpus_h, stream_h, numbers = DECODE_AT_PR28[seed]
    cell = tiny_cell("gov2pfd-decode")
    corp = harness.make_corpus(cell, seed)
    h = hashlib.sha256()
    for t in sorted(corp[1]):
        h.update(corp[1][t][0].tobytes())
        h.update(corp[1][t][1].tobytes())
    assert h.hexdigest()[:16] == corpus_h
    drv = cell.driver.Driver(cell.config, cell.traffic, torch.device("cpu"),
                             lambda msg: None, seed)
    stream = harness.requests(drv, seed, generator.WINDOW, cell)
    reqs = [next(stream) for _ in range(4)]
    assert hashlib.sha256(str(reqs[:3]).encode()).hexdigest()[:16] == (
        stream_h)
    assert control.control(cell, seed, 4, torch.device("cpu"))[
        "numbers"] == numbers
    drv.setup(corp)
    sample, kept = generator.rng(seed, generator.SAMPLE), []
    for i, r in enumerate(reqs):
        kept += drv.keep(r, drv.serve(r), sample,
                         cell.traffic["check_share"], whole=i == 0)
    assert drv.check(corp, kept) == dict(numbers, postings_wrong=0,
                                         lists_wrong=0)


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name):
    """The control (the decode without its exceptions, or one bit too
    narrow; the model's weights in float8) fails the cell's check on three
    seeds."""
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


@pytest.mark.parametrize("name", CELLS)
def test_a_run_loads_no_jax(name):
    """A whole run in a fresh interpreter leaves no module of JAX, the JAX
    package (``repro``, compared whole) or its benchmarks loaded."""
    code = ("import sys; sys.path[:0] = [%r, %r]\n"
            "sys.path.insert(0, %r)\n"
            "from tiny import tiny_run\n"
            "from portbench import harness\n"
            "assert tiny_run(%r)['correct']\n"
            "tops = {m.split('.')[0] for m in sys.modules}\n"
            "print(sorted(tops & harness.FORBIDDEN), 'repro_torch' in tops)\n"
            % (ROOT, os.path.join(ROOT, "src"),
               os.path.join(ROOT, "portbench", "tests"), name))
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.split("\n")[-2] == "[] True"
