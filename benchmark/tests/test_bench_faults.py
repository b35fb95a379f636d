"""The check against planted faults, on the CPU at tiny grids: a step
that returns its state unchanged, one point of a new state altered, and
(the ensemble) half of the members left unstepped must each make
``correct`` false.  The cells have no exchange between chips."""

import pytest

import run
from test_bench_harness import TINY

CASES = [(cell, fault) for cell in sorted(TINY)
         for fault in ("unchanged", "altered")] + [("hex2d.ens16", "half")]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_planted_fault_is_not_correct(cell, fault):
    n, seconds, over = TINY[cell]
    res = run.run_cell(cell, 2 ** 31 + 7, seconds, 0, device="cpu", n=n,
                       fault=fault, overrides=over, out=lambda s: None)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["compared"].values())
