"""CLI parity: the port's mugiq-loop-torch and mugiq-eigensolve-torch
parse every flag of their JAX counterparts (mugiq_tpu.cli.loop and
mugiq_tpu.cli.eigensolve), with the same choices and defaults.

Each parser is captured by patching argparse.ArgumentParser.parse_args to
raise with the parser, so the CLIs' own construction code builds it and
nothing runs.  Every option string of a JAX parser parses in the port's
parse_args at the JAX default value (a flag without a value given alone;
one whose default is None with a value of its type), and one invocation
with every flag at its default parses in both.  A flag added to a JAX CLI
later fails here rather than for a user.  Values that need unported work
raise NotImplementedError naming their ROADMAP item.
"""

import argparse
from unittest import mock

import pytest

from mugiq_tpu.cli import eigensolve as jax_eig
from mugiq_tpu.cli import loop as jax_loop
from mugiq_tpu_torch.cli import eigensolve as port_eig
from mugiq_tpu_torch.cli import loop as port_loop


class _Captured(Exception):
    def __init__(self, parser):
        super().__init__("parser captured")
        self.parser = parser


def _capture(build):
    """The ArgumentParser that build() constructs and parses with."""
    def grab(self, *a, **k):
        raise _Captured(self)

    with mock.patch.object(argparse.ArgumentParser, "parse_args", grab):
        try:
            build()
        except _Captured as c:
            return c.parser
    raise AssertionError("the CLI never parsed")


def _options(parser):
    """{option string: action} without --help."""
    return {s: a for a in parser._actions for s in a.option_strings
            if not isinstance(a, argparse._HelpAction)}


JAX = {"loop": _options(_capture(lambda: jax_loop.main([]))),
       "eigensolve": _options(_capture(lambda: jax_eig.main([])))}
PORT = {"loop": port_loop, "eigensolve": port_eig}
CASES = [(cli, opt) for cli in JAX for opt in sorted(JAX[cli])]

# a value of the flag's type for flags whose JAX default is None
_NONE_VALUE = {"--kappa": ["0.12"], "--mass": ["0.1"], "--platform": ["cpu"],
               "--mesh": ["1", "1"], "--dist-coordinator": ["localhost:1"],
               "--dist-num-processes": ["1"], "--dist-process-id": ["0"]}


def _argv(opt, action):
    """The flag at its JAX default (or a value of its type for None)."""
    if action.nargs == 0:
        return [opt]
    if action.default is None:
        return [opt, *_NONE_VALUE[opt]]
    d = action.default
    return [opt, *map(str, d)] if isinstance(d, list) else [opt, str(d)]


@pytest.mark.parametrize("cli, opt", CASES, ids=[f"{c}{o}" for c, o in CASES])
def test_port_parses_jax_flag(cli, opt):
    action = JAX[cli][opt]
    port = _options(_capture(lambda: PORT[cli].parse_args([])))
    assert opt in port, f"mugiq-{cli}-torch lacks {opt}"
    mine = port[opt]
    assert mine.choices == action.choices, opt
    assert mine.default == action.default, opt
    assert mine.nargs == action.nargs, opt
    args = PORT[cli].parse_args(_argv(opt, action))
    dest = mine.dest
    if action.nargs == 0:
        assert getattr(args, dest) == action.const
    elif action.default is not None:
        assert getattr(args, dest) == action.default


@pytest.mark.parametrize("cli", sorted(JAX))
def test_full_jax_invocation_parses(cli):
    """One production invocation with every flag of the JAX CLI whose
    default is a value (not None) at that default, parsed by both."""
    argv = []
    for opt, action in sorted(JAX[cli].items()):
        if action.default is not None and opt.startswith("--"):
            argv += _argv(opt, action)
    jax_parser = _capture(lambda: (jax_loop if cli == "loop"
                                   else jax_eig).main([]))
    argparse.ArgumentParser.parse_args(jax_parser, argv)
    args = PORT[cli].parse_args(argv)
    assert args.production and args.basis_precision == "f32"


DIMS = ["--dims", "4", "4", "4", "4", "--device", "cpu"]


@pytest.mark.parametrize("cli, flags, item", [
    ("loop", ["--serve", "requests"], "item 13"),
    ("loop", ["--loop-write-pos-space", "yes", "--loop-pos-space-filename",
              "pos.h5"], "item 4"),
    ("loop", ["--prec", "double"], "item 9"),
    ("eigensolve", ["--mugiq-use-mg", "yes"], "item 9")])
def test_unported_values_name_their_item(cli, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        PORT[cli].run(DIMS + flags)


def test_jax_only_flags_are_logged(caplog):
    """--platform, --compile-cache, --autotune and --loop-calc-type are
    accepted and logged once, with no other effect."""
    from mugiq_tpu_torch.cli.common import log_jax_only

    args = port_loop.parse_args(["--platform", "cpu", "--compile-cache", "no",
                                 "--autotune", "--loop-calc-type", "blas"])
    with caplog.at_level("INFO", logger="mugiq_tpu_torch"):
        log_jax_only(args)
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1
    for flag in ("--platform cpu", "--compile-cache no", "--autotune True",
                 "--loop-calc-type blas"):
        assert flag in lines[0]
