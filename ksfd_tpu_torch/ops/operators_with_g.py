"""The with-G variant: the free energy carried as an extra state field.

Counterpart: ksfd_tpu/ops/operators_with_g.py (the reference's legacy
KSFD/ksfdsym_with_G.py, ksfdts_with_G.py).  ``WithGOperators`` works on
a (nligands+2)-field state whose last slot mirrors G.  The derivatives
come from the physical fields exactly as in PDEOperators, and the G
slot's time derivative is zero inside the implicit solve; ``refresh_G``
recomputes the slot from the current fields, and the Solver and the
EnsembleSolver call it after every accepted step, so stored snapshots
carry an up-to-date G.

The fused kernels refuse a with-G state (ops/fused_stencil.py
kernel_refusal), so its steps are unfused, as the reference's are XLA
(ksfd_tpu/ops/pallas_stencil.py:324-330); the block pc applies a
shift-only inverse to the G field (solvers/linalg.py, ``nextra``) and
``pc_pallas`` takes that basis-GEMM pc.  On a mesh each rank holds its
block of every field, G included: ``refresh_G`` is pointwise (the
groomed fields and G at each point), so it needs no halo rows.
"""

import torch

from ..grid import Grid
from ..utils.exceptions import KSFDException
from .operators import PDEOperators

__all__ = ["WithGOperators", "with_g_grid"]


def with_g_grid(grid):
    """The same grid with one extra dof for the G slot."""
    state = grid.state()
    state["dof"] = state["dof"] + 1
    return Grid(**state)


def _strip_g(grid):
    state = grid.state()
    state["dof"] = state["dof"] - 1
    return Grid(**state)


class WithGOperators(PDEOperators):
    """PDE operators over a state with a trailing G field.  ``grid`` is
    the full grid (dof = nligands + 2); the physical operators run on
    ``u[:-1]``."""

    def __init__(self, ps, grid, sources=None, flux_form=False,
                 device=None):
        if grid.dof != ps.nligands + 2:
            raise KSFDException(
                "with-G grid needs dof=%d (rho + %d ligands + G), got %d"
                % (ps.nligands + 2, ps.nligands, grid.dof)
            )
        super().__init__(ps, _strip_g(grid), sources=sources,
                         flux_form=flux_form, device=device)
        # the full grid for the step, the pc and the I/O
        self.grid = grid

    def split(self, u):
        return u[:-1], u[-1]

    def refresh_G(self, u, t=None):
        """The state with its G slot recomputed from the groomed
        physical fields at t (t0 when None)."""
        phys = super().groom(self.split(u)[0])
        return torch.cat([phys, super().G(phys, t)[None]], dim=0)

    def groom(self, u):
        phys, G = self.split(u)
        return torch.cat([super().groom(phys), G[None]], dim=0)

    def rhs(self, u, t, groom=True, mesh=None):
        phys, G = self.split(u)
        dphys = super().rhs(phys, t, groom=groom, mesh=mesh)
        return torch.cat([dphys, torch.zeros_like(G)[None]], dim=0)

    def linearize(self, u, t, primal=True, mesh=None):
        """``(rhs(u, t), v -> J(u) v)`` of the full state: the physical
        fields' (PDEOperators.linearize) and a zero G row; the G slot
        enters neither."""
        phys, G = self.split(u)
        f0, jvp = super().linearize(phys, t, primal=primal, mesh=mesh)
        zero = torch.zeros_like(G)[None]
        if f0 is not None:
            f0 = torch.cat([f0, zero], dim=0)

        def jvp_full(v):
            jv = jvp(v[:-1])
            return torch.cat([jv, torch.zeros_like(jv[:1])], dim=0)

        return f0, jvp_full

    def velocity(self, u, t=None, mesh=None):
        return super().velocity(self.split(u)[0], t, mesh=mesh)

    def stiff_coefficients(self, t):
        diff, decay = super().stiff_coefficients(t)
        # the G slot: no dynamics, a shift-only inverse
        return diff + [0.0], decay + [0.0]
