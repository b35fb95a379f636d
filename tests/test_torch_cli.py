"""The port's command line against ksfd_tpu's, on the CPU.

``ksfd_tpu_torch/ksfdsolver.py:parse_commandline`` (the port's
``Parser``) beside the JAX package's ``ksfdsolver.py`` on every options
file under examples/, and ``ksfd_tpu_torch.utils.cli.decode_numerics``
beside ``ksfd_tpu.utils.cli.decode_numerics`` on each example's blocks
and a table of tokens: the same Namespace, and the same
``NumericsOptions`` field for field (``unrecognized`` notes included),
or the same error.
"""

import importlib.util
import re
from pathlib import Path

import pytest

from ksfd_tpu import KSFDException as JKSFDException
from ksfd_tpu.utils.cli import decode_numerics as jdecode
from ksfd_tpu_torch import KSFDException
from ksfd_tpu_torch import ksfdsolver as tks
from ksfd_tpu_torch.utils.cli import decode_numerics as tdecode

REPO = Path(__file__).resolve().parents[1]
EXAMPLES = sorted(p.name for p in (REPO / "examples").iterdir()
                  if p.is_file() and not p.name.endswith(".sh"))


def _reference_driver():
    spec = importlib.util.spec_from_file_location(
        "ksfd_reference_driver", REPO / "ksfdsolver.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JDRIVER = _reference_driver()

#: command lines around each options file
EXTRAS = {
    "file": [],
    "overrides": ["--numerics", "-device_loop", "1", "--", "maxsteps=64",
                  "--seed=5", "--save_every=3", "--source=rho=x"],
    "equals_block": ["--numerics=-ksp_iters 4 -pc_pallas 1", "dt=0.5",
                     "--ensemble=2", "--onestep"],
}


@pytest.mark.parametrize("extra", sorted(EXTRAS))
@pytest.mark.parametrize("example", EXAMPLES)
def test_parser_matches_reference(example, extra):
    argv = ["@" + str(REPO / "examples" / example)] + EXTRAS[extra]
    got = vars(tks.parse_commandline(argv))
    ref = vars(JDRIVER.parse_commandline(argv))
    assert got == ref
    assert got["params"], "the file's parameters were read"


def _blocks(example):
    ns = tks.parse_commandline(["@" + str(REPO / "examples" / example)])
    return ns.numerics, ns.petsc


#: (native tokens, PETSc tokens) decoded by both packages
TOKENS = {
    "empty": ([], []),
    "arkimex4": (["-ts_type", "arkimex", "-ts_arkimex_type", "4"], []),
    "arkimex3": ([], ["-ts_type", "arkimex", "-ts_arkimex_type", "3"]),
    "arkimex_scheme_on_rosw": (["-ts_arkimex_type", "4"], []),
    "arkimex_bad_scheme": (["-ts_type", "arkimex",
                            "-ts_arkimex_type", "9"], []),
    "beuler": (["-ts_type", "beuler"], []),
    "ts_type_unknown": (["-ts_type", "bdf"], []),
    "adapt_dsp": ([], ["-ts_adapt_type", "dsp"]),
    "adapt_none": (["-ts_adapt_type", "none"], []),
    "negative_clip": (["-ts_adapt_clip", "-0.1,5"], []),
    "mumps_pair": ([], ["-ksp_type", "preonly", "-pc_type", "lu"]),
    "mumps_pair_native_ksp": (["-ksp_type", "banded"],
                              ["-ksp_type", "preonly", "-pc_type", "lu"]),
    "preonly_alone": ([], ["-ksp_type", "preonly"]),
    "pc_cholesky_alone": ([], ["-pc_type", "cholesky"]),
    "pc_mumps": ([], ["-pc_type", "mumps", "-ksp_type", "fgmres"]),
    "snes": ([], ["-snes_type", "newtonls", "-snes_iters", "3"]),
    "ksponly": ([], ["-snes_type", "ksponly"]),
    "switches": (["-precision", "f32", "-ksp_sweep_dtype", "f64",
                  "-pc_dtype", "bf16", "-pc_fft", "auto", "-pc_pallas", "1",
                  "-device_loop", "true", "-use_pallas", "0",
                  "-stage_delta", "False", "-esc_cheb", "0",
                  "-pc_type", "spectral"], []),
    "numbers": (["-cheb_lmin", "0.1", "-cheb_lmax", "2", "-cheb_safety",
                 "0.3", "-ksp_iters", "4", "-ksp_iters_max", "8",
                 "-ksp_iters_max2", "32", "-ksp_gmres_restart", "30",
                 "-ksp_max_it", "100", "-ksp_rtol", "1e-10",
                 "-ts_max_snes_failures", "7", "-ts_adapt_safety", "0.8",
                 "-ts_adapt_scale_solve_failed", "0.5", "-ts_adapt_dt_min",
                 "1e-12", "-ts_adapt_dt_max", "100", "-sweep_dtype",
                 "float32", "-pc_dtype", "float64", "-precision", "x"],
                []),
    "native_overrides_petsc": (["-ts_adapt_dt_max", "50"],
                               ["-ts_adapt_dt_max", "1e4"]),
    "monitor_bare": (["-monitor"], []),
    "monitor_off": ([], ["-ts_adapt_monitor", "0", "-ksp_monitor"]),
    "unknown": ([], ["-options_left", "-foo", "bar", "-mat_type", "aij"]),
    "ksp_kinds": (["-ksp_type", "chebyshev", "-ksp_type", "gmres_scipy",
                   "-ksp_type", "gmres_restarted"], ["-ksp_type", "bcgs"]),
}

#: tokens both packages refuse, with the message's start
BAD = {
    "dt_max_word": ["-ts_adapt_dt_max", "abc"],
    "clip_one_number": ["-ts_adapt_clip", "0.1"],
    "clip_missing": ["-ts_adapt_clip"],
    "iters_missing": ["-ksp_iters"],
    "max_it_float": ["-ksp_max_it", "1.5"],
    "rtol_word": ["-ksp_rtol", "tight"],
}

CASES = ({"example-" + e: _blocks(e) for e in EXAMPLES}
         | {"tokens-" + k: v for k, v in TOKENS.items()})


@pytest.mark.parametrize("case", sorted(CASES))
def test_decode_numerics_matches_reference(case, capsys):
    tokens, petsc = CASES[case]
    got = tdecode(tokens, petsc_tokens=petsc)
    port_err = capsys.readouterr().err
    ref = jdecode(tokens, petsc_tokens=petsc)
    assert got.asdict() == ref.asdict()
    # the same note on stderr where a token was ignored or translated
    assert port_err == capsys.readouterr().err
    assert bool(port_err) == bool(got.unrecognized)
    if case == "tokens-mumps_pair":
        assert got.petsc_direct and got.ksp_type == "richardson"
    if case == "tokens-arkimex4":
        # decoded; the Solver refuses it (Queue A item 7, A9)
        assert got.ts_type == "ark436"


@pytest.mark.parametrize("case", sorted(BAD))
def test_decode_numerics_refuses_bad_values_as_reference(case):
    with pytest.raises(KSFDException) as got:
        tdecode(BAD[case])
    with pytest.raises(JKSFDException) as ref:
        jdecode(BAD[case])
    assert str(got.value) == str(ref.value)
    assert str(got.value).startswith("bad or missing value")


def test_parser_at_file_comments_and_quotes(tmp_path):
    """An options file's '#' comments and quoted lines, a parameter
    given before an option on the command line, and a block left open
    at the end of the input (it runs to the end)."""
    opt = tmp_path / "opts"
    opt.write_text("# a comment\n'rho0=9000 + sin(2*pi*x)'  # trailing\n"
                   "--resume=r # comment\n--petsc -ts_type rosw\n")
    argv = ["maxsteps=2", "--check=c", "@" + str(opt)]
    got = tks.parse_commandline(argv)
    assert vars(got) == vars(JDRIVER.parse_commandline(argv))
    assert got.params == ["maxsteps=2", "rho0=9000 + sin(2*pi*x)"]
    assert got.petsc == ["-ts_type", "rosw"]
    assert got.resume == "r" and got.check == "c"


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports JAX or the
    JAX package (the CUDA machine has neither)."""
    pattern = re.compile(r"^\s*(import|from) (jax|ksfd_tpu)\b")
    files = sorted((REPO / "ksfd_tpu_torch").rglob("*.py")) + [
        REPO / "chip_smoke.py"]
    assert Path(tks.__file__) in files
    for path in files:
        for n, line in enumerate(path.read_text().splitlines(), 1):
            assert not pattern.match(line), "%s:%d: %s" % (path, n, line)
