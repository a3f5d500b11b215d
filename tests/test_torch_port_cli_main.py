"""``diffdock-tpu-torch``, the port's console entry point (pyproject
[project.scripts]), as ``tests/test_cli_main.py`` checks the JAX package's."""

import importlib
import os
import tomllib
from pathlib import Path

import pytest

from diffdock_tpu.cli.main import _COMMANDS as J_COMMANDS
from diffdock_tpu_torch.cli.main import _COMMANDS, _apply_restrict_cpu, main

REPO = Path(__file__).resolve().parent.parent


def test_help_lists_every_command_of_the_jax_dispatcher(capsys):
    assert main(["--help"]) == 0
    out = capsys.readouterr().out
    assert list(_COMMANDS) == list(J_COMMANDS)
    for name in _COMMANDS:
        assert name in out
    assert main([]) == 0


def test_unknown_command_is_an_error(capsys):
    assert main(["frobnicate"]) == 2
    assert "unknown command 'frobnicate'" in capsys.readouterr().err


def test_underscore_alias_dispatches():
    # argparse --help exits 0 through SystemExit: the dispatch reached the
    # subcommand's parser
    for cmd in ("import_weights", "confidence_train"):
        with pytest.raises(SystemExit) as e:
            main([cmd, "--help"])
        assert e.value.code == 0


def test_entry_point_matches_pyproject():
    with open(REPO / "pyproject.toml", "rb") as f:
        scripts = tomllib.load(f)["project"]["scripts"]
    mod, _, fn = scripts["diffdock-tpu-torch"].partition(":")
    assert callable(getattr(importlib.import_module(mod), fn))
    assert getattr(importlib.import_module(mod), fn) is main


@pytest.mark.parametrize("cmd", ["esm-prep", "prewarm", "esm_prep"])
def test_unported_commands_are_refused_with_their_item(cmd):
    """esm-prep (either spelling) and prewarm dispatch to their modules:
    --help reaches the module's parser, which exits 0."""
    with pytest.raises(SystemExit) as e:
        main([cmd, "--help"])
    assert e.value.code == 0


def test_restrict_cpu_caps_pools_before_import(monkeypatch):
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        monkeypatch.delenv(var, raising=False)
    _apply_restrict_cpu(["evaluate", "--restrict_cpu", "--num_cpu", "3"])
    assert os.environ["OMP_NUM_THREADS"] == "3"
    assert os.environ["OPENBLAS_NUM_THREADS"] == "3"
    monkeypatch.delenv("OMP_NUM_THREADS")
    _apply_restrict_cpu(["evaluate"])  # no flag: no exports
    assert "OMP_NUM_THREADS" not in os.environ
