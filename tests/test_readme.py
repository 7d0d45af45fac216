"""Docs-as-tests: execute the README's code blocks verbatim.

Reference CI runs its README Python codeblocks (pytest-codeblocks) and three
CLI invocations verbatim (.github/workflows/ci.yml:61-75); this module does
the same without a plugin: it extracts every fenced block from README.md and
runs Python blocks with exec() and bash blocks through the CLI entry point.

The blocks use production sweep counts (minutes on CPU), so they run only
when ``PEAPODS_README_TESTS=1`` — set by the dedicated CI job.  A cheap
structural check (blocks parse / flags exist) always runs.
"""

import os
import re
import shlex
from pathlib import Path

import pytest

README = Path(__file__).parent.parent / "README.md"
RUN_FULL = os.environ.get("PEAPODS_README_TESTS") == "1"


def _blocks(lang):
    text = README.read_text()
    return re.findall(rf"```{lang}\n(.*?)```", text, re.DOTALL)


def _bash_commands():
    cmds = []
    for block in _blocks("bash"):
        # join line continuations, drop comments/non-peapods lines
        joined = block.replace("\\\n", " ")
        for line in joined.splitlines():
            line = line.strip()
            if line.startswith("peapods "):
                cmds.append(line)
    return cmds


def test_readme_python_blocks_compile():
    blocks = _blocks("python")
    assert blocks, "README lost its python example"
    for block in blocks:
        compile(block, "<README>", "exec")


def test_readme_cli_commands_parse():
    from peapods_tpu.cli import build_parser

    cmds = _bash_commands()
    assert len(cmds) >= 2, "README lost its CLI examples"
    parser = build_parser()
    for cmd in cmds:
        # parse_args exits on unknown flags — exactly the regression to catch
        parser.parse_args(shlex.split(cmd)[1:])


@pytest.mark.skipif(not RUN_FULL, reason="set PEAPODS_README_TESTS=1")
@pytest.mark.parametrize("idx", range(len(_blocks("python"))))
def test_readme_python_blocks_run_verbatim(idx):
    block = _blocks("python")[idx]
    exec(compile(block, "<README>", "exec"), {})


@pytest.mark.skipif(not RUN_FULL, reason="set PEAPODS_README_TESTS=1")
@pytest.mark.parametrize("idx", range(len(_bash_commands())))
def test_readme_cli_commands_run_verbatim(idx, capsys):
    from peapods_tpu.cli import main

    cmd = _bash_commands()[idx]
    main(shlex.split(cmd)[1:])
    assert "Binder" in capsys.readouterr().out
