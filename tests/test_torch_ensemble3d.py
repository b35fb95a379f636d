"""The port's EnsembleSolver on 3D problems and with the fused pc
(``pc_pallas``) against the reference's on the CPU.

On the CPU the member-batched kernels run their plain versions member by
member (the vmap rule of ops/fused_stencil.py, which ops/fused_pc.py
shares).  The 3D problem is ``examples/aggregation3d`` at 16 x 8 x 16 x 3
(tests/test_torch_3d.py), its members ``wave_state * (1 + 1e-4 N(0,1))``;
the reference runs its 3D Pallas kernels in interpret mode.  The
pc_pallas ensemble runs the bench problem at 32^2 x 3; there the
reference's gate (128-aligned axes, pallas_pc.py:66) sends its
``pc_pallas`` request to the einsum apply with ``rho_diff`` set, the same
function in float32, while the port runs its fused pc (B5a/B5b).
Tolerances as tests/test_torch_ensemble.py: fixed dt within 1e-5 of the
increment; adaptive runs with the same k and snes_failures, t and h
within ADAPT_RTOL relative and u within ADAPT_RTOL of the increment.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ksfd_tpu import NumericsOptions as JNumerics
from ksfd_tpu.solvers import EnsembleSolver as JEnsemble
from ksfd_tpu_torch import NumericsOptions
from ksfd_tpu_torch.ops import fused_pc, fused_stencil
from ksfd_tpu_torch.solvers import EnsembleSolver, make_multistep_fn
from test_torch_3d import SHAPE, _problems, wave_state
from test_torch_ensemble import (
    ADAPT_RTOL,
    KW,
    increment,
    members,
    one_thread,  # noqa: F401 (autouse fixture)
    prob,  # noqa: F401 (fixture: the 2D bench problem at 32^2)
)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setenv("KSFD_PALLAS_INTERPRET", "1")


@pytest.fixture(scope="module")
def prob3():
    """(JAX ops, port ops) of aggregation3d at SHAPE x 3."""
    return _problems(SHAPE)


def members3(n, seed=42):
    """n members ``wave_state * (1 + 1e-4 N(0,1))``."""
    base = wave_state()
    rng = np.random.default_rng(seed)
    return np.stack([base * (1.0 + 1e-4 * rng.standard_normal(base.shape))
                     for _ in range(n)])


def run_both(jops, tops, nm, U0, **kw):
    """The reference's and the port's EnsembleSolver on U0."""
    ref = JEnsemble(jops, JNumerics(**nm), **kw).solve(jnp.asarray(U0))
    out = EnsembleSolver(tops, NumericsOptions(**nm), **kw).solve(U0)
    return ref, out


def assert_adaptive_parity(ref, out, U0):
    np.testing.assert_array_equal(out.k, ref.k)
    np.testing.assert_array_equal(out.snes_failures, ref.snes_failures)
    np.testing.assert_allclose(out.t, ref.t, rtol=ADAPT_RTOL)
    np.testing.assert_allclose(out.h, ref.h, rtol=ADAPT_RTOL)
    assert out.u.dtype == torch.float64
    assert float(np.abs(out.u.numpy() - np.asarray(ref.u)).max()) \
        <= ADAPT_RTOL * increment(U0, ref.u)


def test_3d_fixed_dt_ensemble_matches_reference_and_members(prob3,
                                                            interpret):
    """A 3D fixed-dt ensemble (2 members, one 2-step block at h=1e-2):
    each member within 1e-5 of the increment of the reference's
    EnsembleSolver, and equal to its own single-member make_multistep_fn
    run to 1e-12 of the increment."""
    jops, tops = prob3
    U0 = members3(2)
    kw = dict(KW, dt=1e-2, maxsteps=2)
    ref, out = run_both(jops, tops, dict(adapt_type="none"), U0, **kw)
    es_out = EnsembleSolver(tops, NumericsOptions(adapt_type="none"),
                            block_steps=2, **kw).solve(U0)
    inc = increment(U0, ref.u)
    for o in (out, es_out):
        assert (o.k == 2).all() and np.allclose(o.t, 0.02)
        assert not o.diverged.any() and (o.snes_failures == 0).all()
        assert float(np.abs(o.u.numpy() - np.asarray(ref.u)).max()) \
            <= 1e-5 * inc
    multi, _ = make_multistep_fn(tops, NumericsOptions(adapt_type="none"),
                                 atol=0.01, rtol=1e-6)
    for i in range(2):
        u, _, _ = multi(tops.groom(torch.from_numpy(U0[i])),
                        torch.tensor(0.0, dtype=torch.float64),
                        torch.tensor(1e-2, dtype=torch.float64), 2)
        assert float((es_out.u[i] - u).abs().max()) <= 1e-12 * inc


def test_3d_adaptive_ensemble_matches_reference(prob3, interpret):
    """A 3D adaptive per-step ensemble (2 members, 4 steps from
    dt=1e-3): the reference's k, snes_failures, t and h."""
    jops, tops = prob3
    U0 = members3(2)
    ref, out = run_both(jops, tops, {}, U0, **dict(KW, dt=1e-3, maxsteps=4))
    assert (out.k == 4).all()
    assert_adaptive_parity(ref, out, U0)


def test_pc_pallas_fixed_dt_ensemble_matches_reference(prob, interpret):
    """A pc_pallas fixed-dt ensemble at 32^2 x 3 (2 members, 2 steps at
    h=1e-2) within 1e-5 of the increment of the reference's."""
    jops, tops = prob
    U0 = members(tops.grid, 2)
    ref, out = run_both(jops, tops, dict(adapt_type="none", pc_pallas=True),
                        U0, **dict(KW, dt=1e-2, maxsteps=2))
    assert (out.k == 2).all() and not out.diverged.any()
    assert float(np.abs(out.u.numpy() - np.asarray(ref.u)).max()) \
        <= 1e-5 * increment(U0, ref.u)


def test_pc_pallas_adaptive_ensemble_matches_reference(prob, interpret):
    """A pc_pallas adaptive per-step ensemble at 32^2 x 3 (2 members, 4
    steps from dt=1e-3): the reference's k, snes_failures, t and h."""
    jops, tops = prob
    U0 = members(tops.grid, 2)
    ref, out = run_both(jops, tops, dict(pc_pallas=True), U0,
                        **dict(KW, dt=1e-3, maxsteps=4))
    assert (out.k == 4).all()
    assert_adaptive_parity(ref, out, U0)


@pytest.mark.parametrize("case", ["3d f64", "3d f32", "pc_pallas f64"])
def test_launch_counts_independent_of_members(prob, prob3, monkeypatch,
                                              case):
    """The kernel calls of a 3D or pc_pallas ensemble step are the same
    whatever the member count: each vmapped call of a stencil or
    fused-pc kernel is one batched call (one launch on a card), and no
    operand reaches a kernel unbatched (the vmap rule copies none to
    the members).  Counted at the vmap rule on the CPU over a 2-step
    block."""
    calls = {}
    for cls in (fused_stencil.FusedKernel, fused_pc.PCKernel):
        real = cls.run_batched

        def counting(self, sc, operands, _real=real):
            calls[self.name] = calls.get(self.name, 0) + 1
            return _real(self, sc, operands)

        monkeypatch.setattr(cls, "run_batched", counting)
    ops = prob3[1] if case.startswith("3d") else prob[1]
    nm = NumericsOptions(adapt_type="none", pc_pallas="pc" in case,
                         precision="float32" if "f32" in case else "float64")
    base = wave_state() if case.startswith("3d") else None
    per_n = {}
    for n in (1, 3):
        calls.clear()
        U0 = (np.stack([base] * n) if base is not None
              else members(ops.grid, n))
        es = EnsembleSolver(ops, nm, block_steps=2,
                            **dict(KW, dt=1e-3, maxsteps=2))
        es.solve(U0)
        per_n[n] = dict(calls)
        wrappers = list(es.kernels.kernels.values()) + (
            list(es.fused_pc.kernels.values()) if es.fused_pc else [])
        assert [w.broadcasts for w in wrappers] == [0] * len(wrappers)
    want = dict(rhs=8, jvp=16) if "f32" in case else dict(resid=16, delta=8)
    if "pc" in case:
        want.update(pc_fwd=24, pc_inv=24)
    assert per_n[1] == per_n[3] == want
