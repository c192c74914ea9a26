"""``tools/registry_lint_torch.py``, the port's registry lint: it passes on
the tree, and a bad registry entry makes it fail with the check that names
it (the JAX package's ``tools/registry_lint.py`` checks the reference)."""

import dataclasses
import importlib.util
import os

import pytest
import torch

from repro_torch.core import codec

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def lint():
    path = os.path.join(ROOT, "tools", "registry_lint_torch.py")
    spec = importlib.util.spec_from_file_location("registry_lint_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lint_passes_on_the_tree(lint, capsys):
    assert lint.main(["--torch-device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "31 codecs (18 TorchDecode, 19 ArenaLayout), 0 error(s)" in out
    assert "repro_torch on cpu" in out
    assert "FAIL" not in out
    assert len(lint.CHECKS) == 10


def test_lint_defaults_to_the_card_and_raises_without_one(lint,
                                                          monkeypatch):
    """No device named: the lint runs on the card, and a machine without
    one raises instead of falling back to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lint.main([])


def _bogus_protocol(spec):
    return dataclasses.replace(spec, category="bogus", max_bits=40)


def _no_exception_column(spec):
    """The patch stream still decodes, but under another column name: the
    declaration no longer says the blocks carry exceptions."""
    lay = spec.arena
    cols = tuple(dataclasses.replace(c, name="patches")
                 if c.name == "exceptions" else c for c in lay.columns)
    return dataclasses.replace(spec, arena=dataclasses.replace(
        lay, columns=cols))


@pytest.mark.parametrize("name, corrupt, check, needle", [
    ("varbyte", _bogus_protocol, "lint_protocol", "category 'bogus'"),
    ("group_pfd", _no_exception_column, "lint_exception_columns",
     "without an 'exceptions' column"),
])
def test_bad_registry_entry_fails(lint, monkeypatch, capsys, name, corrupt,
                                  check, needle):
    monkeypatch.setitem(codec.REGISTRY, name, corrupt(codec.get(name)))
    errors = []
    getattr(lint, check)(errors, "cpu")
    assert errors and any(needle in e for e in errors), errors
    assert lint.main(["--torch-device", "cpu"]) == 1
    assert needle in capsys.readouterr().out
