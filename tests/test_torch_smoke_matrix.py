"""The port's smoke matrix (``ksfd_tpu_torch/tools/smoke_matrix.py``,
the counterpart of tools/smoke_matrix.py) on the CPU: its ``--quick``
grid, every stepper (rosw, arkimex, ark436, beuler) with every stage
solver (richardson, chebyshev, gmres, gmres_scipy, gmres_rolled,
gmres_restarted, dense, banded, lu), 3 Solver steps each of the 1D
manufactured problem at 32, prints no CRASH and no BAD: the DIRK
tableaus with the exact host tiers are rejected as the reference
rejects them, and everything else takes its 3 steps to a finite
state.  It takes one to two minutes on the CPU (gmres_rolled's default
50 cycles of GMRES(20) per stage solve dominate)."""

from ksfd_tpu_torch.tools import smoke_matrix


def test_quick_matrix_prints_no_crash(capsys):
    quick = smoke_matrix.cases(quick=True)
    assert len(quick) == 36
    assert all(kw in quick for kw in smoke_matrix.EXPECTED_REJECT)
    assert len(smoke_matrix.cases()) == 36 + 6 + 6 + 11
    assert smoke_matrix.main(["--quick", "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    lines = [ln for ln in out.splitlines() if ln[:5].strip() in
             ("OK", "BAD", "CRASH")]
    assert len(lines) == 36
    assert all(ln.startswith("OK ") for ln in lines), out
    assert sum("(rejected:" in ln for ln in lines) == 4
    assert "0/36 failed" in out
