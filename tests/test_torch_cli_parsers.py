"""The port's CLIs take every command line the JAX CLIs take.

Each of the four port CLIs' parsers (retrieval, QA, and the pretraining
parser of the pretraining and prompter CLIs) declares every option string
of its JAX parser, with JAX's type and default; the port adds only
``--device`` and the keys that the JAX CLIs read from a config file. Every
``run_scripts/*.sh`` command line, with the module's package swapped for
``alpro_tpu_torch``, parses to JAX's values (``--inference_split test`` of
the ``inf_*.sh`` scripts included).
"""

import argparse
import importlib
import re
import shlex
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent
CLIS = {"run_video_retrieval": "get_video_retrieval_args", "run_video_qa": "get_video_qa_args",
        "run_pretrain": "get_pretraining_args", "run_prompter": "get_pretraining_args"}
PORT_ONLY = {"--device", "--apply_weight_decay", "--prefetch_depth", "--vtm_negative_blocks",
             "--prompt_chunk_size", "--num_val_batches"}
SCRIPTS = sorted((REPO / "run_scripts").glob("*.sh"))


def _actions(parse) -> dict:
    """{option string: (dest, type, default, nargs)} of the parser that
    ``parse`` builds."""
    seen = {}
    original = argparse.ArgumentParser.parse_args

    def grab(self, *args, **kwargs):
        for action in self._actions:
            for opt in action.option_strings:
                seen[opt] = (action.dest, action.type, action.default, action.nargs)
        return original(self, *args, **kwargs)

    argparse.ArgumentParser.parse_args = grab
    try:
        parse([])
    finally:
        argparse.ArgumentParser.parse_args = original
    return seen


def _parsers(cli: str):
    """(the port CLI module's parser, JAX's) for CLI module ``cli``."""
    name = CLIS[cli]
    port = importlib.import_module(f"alpro_tpu_torch.cli.{cli}")
    return getattr(port, name), getattr(importlib.import_module("alpro_tpu.core.config"), name)


@pytest.mark.parametrize("cli", sorted(CLIS))
def test_port_parser_declares_every_jax_flag(cli):
    port, jax_parse = _parsers(cli)
    got, want = _actions(port), _actions(jax_parse)
    assert set(want) <= set(got), sorted(set(want) - set(got))
    assert set(got) - set(want) <= PORT_ONLY
    for opt in want:
        assert got[opt] == want[opt], opt


def _command_line(script: Path) -> tuple:
    """(CLI module, argv) of the ``python -m alpro_tpu.cli.X`` call in
    ``script``, its shell variables put in and ``"$@"`` dropped."""
    text = script.read_text()
    env = dict(re.findall(r"^(\w+)='([^']*)'", text, re.M))
    call = re.search(r"python -m alpro_tpu\.cli\.(\w+)(.*?)(?:\"\$@\"|$)", text, re.S)
    args = call.group(2).replace("\\\n", " ")
    args = re.sub(r"\$\(date[^)]*\)", "20260101000000", args)
    args = re.sub(r"\$(\w+)", lambda m: env[m.group(1)], args)
    return call.group(1), shlex.split(args)


@pytest.mark.parametrize("script", SCRIPTS, ids=lambda p: p.name)
def test_run_script_parses_on_the_port(script, monkeypatch):
    monkeypatch.chdir(REPO)
    cli, argv = _command_line(script)
    assert "--config" in argv
    port, jax_parse = _parsers(cli)
    got, want = dict(port(argv)), dict(jax_parse(argv))
    assert got.pop("device") == "cuda"
    assert {k: got[k] for k in want} == want
    assert set(got) - set(want) <= {opt[2:] for opt in PORT_ONLY}
    if script.name.startswith("inf_"):
        assert got["inference_split"] == "test" and got["do_inference"] is True
