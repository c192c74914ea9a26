"""The port's model-serving entry points on the CPU:
``python -m repro_torch.launch.serve --arch ...`` (the LM half of the
reference's ``launch/serve.py``) and the three examples of this slice,
``examples/quickstart_torch.py``, ``serve_quickstart_torch.py`` and
``serve_lm_torch.py``, each with ``--torch-device cpu``; the MoE archs
(deepseek-v2-lite-16b, mixtral-8x22b) print the reference's line too, and
so do the recsys archs on each serving cell (``--shape``); EGNN, which
has only train cells, names its ROADMAP.md step; the default device is the
card."""

import os
import re
import subprocess
import sys

import pytest
import torch

from repro_torch.launch import serve

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DECODED = re.compile(r"^decoded (\d+) steps x batch 2 in [0-9.]+ ms$", re.M)


def _run(args: list, timeout: int = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)


def test_launch_serve_arch_smoke_on_cpu():
    out = _run(["-m", "repro_torch.launch.serve", "--arch", "smollm-135m",
                "--smoke", "--torch-device", "cpu"])
    assert out.returncode == 0, out.stderr
    m = DECODED.search(out.stdout)
    assert m and m.group(1) == "8", out.stdout       # the reference's line


@pytest.mark.parametrize("arch", ["starcoder2-3b", "starcoder2-7b",
                                  "deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_launch_serve_arch_in_process(arch, capsys):
    serve.main(["--arch", arch, "--smoke", "--tokens", "3",
                "--torch-device", "cpu"])
    assert re.search(r"^decoded 3 steps x batch 2 in [0-9.]+ ms$",
                     capsys.readouterr().out, re.M)


def test_launch_serve_names_the_step_of_what_waits(capsys):
    """``--arch din`` serves and prints the reference's line; EGNN has only
    train cells and raises, naming the training slice, with ``--shape`` or
    without (the reference fails there with an IndexError or an
    AttributeError)."""
    serve.main(["--arch", "din", "--smoke", "--torch-device", "cpu"])
    assert capsys.readouterr().out.strip().endswith("serve_p99: output (8,) ok")
    with pytest.raises(NotImplementedError, match="A.13.4"):
        serve.main(["--arch", "egnn", "--smoke", "--torch-device", "cpu"])
    with pytest.raises(NotImplementedError, match="A.13.4"):
        serve.main(["--arch", "egnn", "--shape", "molecule", "--smoke",
                    "--torch-device", "cpu"])
    with pytest.raises(SystemExit):        # neither --arch nor --index
        serve.main(["--smoke"])
    with pytest.raises(SystemExit):        # a cell the arch does not have
        serve.main(["--arch", "din", "--shape", "decode_32k", "--smoke",
                    "--torch-device", "cpu"])


@pytest.mark.parametrize("arch", ["din", "dien", "wide-deep", "dlrm-rm2"])
@pytest.mark.parametrize("shape,out", [("serve_p99", 8), ("serve_bulk", 8),
                                       ("retrieval_cand", 64)])
def test_launch_serve_recsys_cells_on_cpu(arch, shape, out, capsys):
    """Each recsys arch and serving cell prints the reference's line
    (``<cell>: output (...) ok``); a train cell names training."""
    serve.main(["--arch", arch, "--shape", shape, "--smoke",
                "--torch-device", "cpu"])
    assert capsys.readouterr().out.strip() == f"{shape}: output ({out},) ok"
    if shape == "serve_p99":
        with pytest.raises(NotImplementedError, match="A.13.4"):
            serve.main(["--arch", arch, "--shape", "train_batch", "--smoke",
                        "--torch-device", "cpu"])


def test_launch_serve_recsys_in_a_subprocess():
    out = _run(["-m", "repro_torch.launch.serve", "--arch", "dien", "--shape",
                "retrieval_cand", "--smoke", "--torch-device", "cpu"])
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "retrieval_cand: output (64,) ok"


def test_launch_serve_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "smollm-135m", "--smoke"])


@pytest.mark.parametrize("arch", ["deepseek-v2-lite-16b", "mixtral-8x22b"])
def test_launch_serve_moe_defaults_to_the_card(arch):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", arch, "--smoke"])


def test_launch_serve_recsys_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.main(["--arch", "din", "--shape", "serve_p99", "--smoke"])


@pytest.mark.parametrize("script,expect", [
    ("serve_lm_torch.py", r"generated \(4, 16\) tokens in [0-9.]+ ms"),
    ("serve_quickstart_torch.py",
     r"served 128/128 requests .*\n(.*\n)*parity: batch 0 .* bitwise identical"),
    ("quickstart_torch.py",
     r"device engine: .*exact parity(.*\n)*ranked top-k: .*exact parity"),
], ids=["serve_lm", "serve_quickstart", "quickstart"])
def test_examples_run_on_cpu(script, expect):
    out = _run([os.path.join("examples", script), "--torch-device", "cpu"])
    assert out.returncode == 0, out.stderr[-2000:]
    assert re.search(expect, out.stdout), out.stdout


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    out = _run([os.path.join("examples", "serve_lm_torch.py")])
    assert out.returncode != 0 and "no CUDA device" in out.stderr
