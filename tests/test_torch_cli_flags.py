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
raise NotImplementedError naming their ROADMAP item.  Without
--production both CLIs take the API path, as the JAX CLIs do: a JAX
invocation gives the same eigenvalues in both packages (4^4, fp64), and
--mesh there is a usage error.
"""

import argparse
from unittest import mock

import numpy as np
import pytest
import torch

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
    ("loop", ["--serve", "requests"], "item 13")])
def test_unported_values_name_their_item(cli, flags, item):
    with pytest.raises(NotImplementedError, match=item):
        PORT[cli].run(DIMS + flags)


# a small converged API-path solve at 4^4
API = ["--gauge", "weak:0.5", "--gauge-seed", "1", "--kappa", "0.13",
       "--eig-nev", "4", "--eig-nkr", "16", "--eig-tol", "1e-10",
       "--eig-use-poly-acc", "--eig-poly-deg", "8", "--eig-amin", "0.09"]
# the MG-coarse eigensolve: unfiltered (the coarse spectrum has its own
# window), fp64
MG = API[:-5] + ["--prec", "double", "--eig-max-restarts", "400",
                 "--mg-block-size", "2", "2", "2", "2", "--mg-nvec", "4",
                 "--mg-setup-iters", "6"]


@pytest.mark.parametrize("cli, flags", [
    ("loop", API + ["--prec", "double"]),
    ("eigensolve", MG + ["--mugiq-use-mg", "yes"])],
    ids=["loop-fp64", "eig-mg"])
def test_item9_values_run(cli, flags):
    """The values that waited for the API path now run it: --prec double
    (complex128) and the MG-coarse eigensolve."""
    got = PORT[cli].run(DIMS + flags)
    res = got[1] if cli == "loop" else got[0]
    assert res.output.converged and res.output.resids.max() < 1e-8
    if cli == "loop":
        assert res.evecs.dtype == torch.complex128
        assert got[0].data_mom.shape == (1, 1, 16, 4)
    else:
        assert res.mg_env is not None
        assert res.evecs.shape == (4, 2, 2, 2, 2, 2, 4)


@pytest.mark.parametrize("cli", sorted(JAX))
def test_api_invocation_matches_jax_cli(cli):
    """One invocation without --production through the JAX CLI and the
    port's (fp64, 4^4): the same eigenvalues."""
    from mugiq_tpu import api as japi

    jax_main = (jax_loop if cli == "loop" else jax_eig).main
    fn = "compute_loop" if cli == "loop" else "compute_evecs_mugiq"
    argv = ["--dims", "4", "4", "4", "4", "--prec", "double",
            "--compile-cache", "no"] + API
    captured = []
    real = getattr(japi, fn)

    def spy(*a, **k):
        captured.append(real(*a, **k))
        return captured[-1]

    with mock.patch.object(japi, fn, spy):
        assert jax_main(argv) == 0
    jres = captured[0][1] if cli == "loop" else captured[0]
    out = PORT[cli].run(argv + ["--device", "cpu"])
    got = out[1] if cli == "loop" else out[0]
    np.testing.assert_allclose(np.sort(got.evals.real),
                               np.sort(np.asarray(jres.evals).real),
                               rtol=1e-10)


@pytest.mark.parametrize("cli", sorted(JAX))
def test_mesh_without_production_is_a_usage_error(cli, capsys):
    with pytest.raises(SystemExit) as e:
        PORT[cli].run(DIMS + ["--mesh", "1", "1"])
    assert e.value.code == 2
    assert "--mesh runs the production path only" in capsys.readouterr().err


def test_production_prec_double_is_logged(caplog):
    """The production path reads no --prec (f32, as the JAX CLI's)."""
    from mugiq_tpu_torch.cli.common import log_production_prec

    with caplog.at_level("INFO", logger="mugiq_tpu_torch"):
        log_production_prec(port_loop.parse_args(["--prec", "double"]))
        log_production_prec(port_loop.parse_args([]))
    lines = [r.getMessage() for r in caplog.records]
    assert len(lines) == 1 and "computes in f32" in lines[0]


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
