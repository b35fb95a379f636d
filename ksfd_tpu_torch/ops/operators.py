"""The Keller-Segel PDE operator: RHS, free energy G, J-action.

Counterpart: ksfd_tpu/ops/operators.py:PDEOperators.  The same math:

- free energy   G = V(U..) + Vcap(rho) + s2*log(rho)
- worm density  drho/dt = grad(rho).grad(G) + rho*laplacian(G) + source
                (the product-rule discretization of div(rho grad G));
                with ``flux_form=True`` the conservative
                sum_d D1_d(rho * D1_d(G)), which conserves sum(rho) to
                roundoff (the first-derivative stencil is antisymmetric)
- each ligand   dU/dt = -gamma*U + s*rho + D*laplacian(U) + source

The pointwise nonlinearity is a sympy expression compiled to a torch
function (utils/symbolic.py torchify); the stencils are ``torch.roll``
linear combinations (ops/stencil.py).  The exact matrix-free J-action
is ``torch.func.jvp`` of the RHS; ``linearize`` gives the RHS and the
same J-action from coefficient fields evaluated once.  The float32
kernels of the main path get the same expressions printed as CUDA
(ops/codegen.py).
"""

import numbers

import sympy as sy
import torch

from ..utils.device import resolve_device
from ..utils.exceptions import KSFDException
from ..utils.symbolic import torchify
from .spatial import SpatialExpression
from .stencil import deriv_apply, grad_apply, laplacian_apply
from .stencil import laplacian_symbol as _laplacian_symbol

__all__ = ["PDEOperators"]

_T = sy.Symbol("t")


class PDEOperators:
    """Callable PDE operators for one problem on one grid.

    Counterpart: ksfd_tpu/ops/operators.py:PDEOperators.

    Parameters
    ----------
    ps : SolutionParameters
    grid : Grid with dof == ps.nligands + 1
    sources : optional list of nligands+1 source terms (expressions /
        SpatialExpressions), rho first.
    flux_form : the conservative discretization of the rho row (module
        docstring); the fused kernels refuse it (ops/fused_stencil.py
        kernel_refusal), so its steps are unfused, as the reference's
        are XLA (ksfd_tpu/ops/pallas_stencil.py:332-336).
    device : where source terms are evaluated and the step's buffers
        live; the card unless given (utils/device.py).  The operators
        act on tensors of any device.
    """

    def __init__(self, ps, grid, sources=None, flux_form=False,
                 device=None):
        self.flux_form = bool(flux_form)
        self.ps = ps
        self.grid = grid
        self.dim = grid.dim
        self.sw = grid.stencil_width
        self.spacing = tuple(float(h) for h in grid.spacing)
        self.nligands = ps.nligands
        self.device = resolve_device(device)
        if grid.dof != ps.nligands + 1:
            raise KSFDException(
                "grid.dof=%d but problem has %d fields"
                % (grid.dof, ps.nligands + 1)
            )
        if sources is None:
            sources = [0.0] * (ps.nligands + 1)
        self.sources = [
            s
            if isinstance(s, SpatialExpression)
            else SpatialExpression(ps, grid, s, device=self.device)
            for s in sources
        ]
        self._source_active = [not s.is_zero() for s in self.sources]

        # groom bounds are t0 values, as in the reference
        self.rhomin = float(ps.values0["rhomin"])
        self.Umin = float(ps.values0["Umin"])

        self._build_G()
        self._build_ligand_coeffs()
        self._build_s2()

    # ------------------------------------------------------------------
    def _resolve_td(self, expr, allowed=()):
        """Substitute time-dependent parameter symbols with their
        resolved expressions in t; returns (expr_in_t, is_time_dep)."""
        if isinstance(expr, numbers.Number):
            return sy.Float(float(expr)), False
        allowed = set(allowed) | {_T}
        resolved = self.ps.resolved
        for _ in range(4):
            free = [s for s in expr.free_symbols if s not in allowed]
            if not free:
                break
            subs = {s: resolved[str(s)] for s in free if str(s) in resolved}
            if not subs:
                break
            expr = expr.subs(subs)
        extra = [s for s in expr.free_symbols if s not in allowed]
        if extra:
            raise KSFDException(
                "unresolved symbols {s} in PDE coefficient {e!r}".format(
                    s=sorted(map(str, extra)), e=str(expr)
                )
            )
        return expr, _T in expr.free_symbols

    def _build_G(self):
        """Compile G(rho, U..., t), each dG/dfield and the increment
        form G_delta (None when delta_expr has no rewrite)."""
        from .delta import UnsupportedDelta, delta_expr, torchify_delta

        ps = self.ps
        rho = sy.Symbol("rho")
        Us = [sy.Symbol(lig.name()) for lig in ps.Vgroups.ligands()]
        params = ps.time_dependent_symbols()
        Gexp = ps.V(Us, rho, params=params) + params["s2"] * sy.log(rho)
        Gexp, self._G_tdep = self._resolve_td(Gexp, allowed=[rho] + Us)
        fields = [rho] + Us
        self.field_symbols = fields
        self.G_expr = Gexp
        self.dG_exprs = [sy.diff(Gexp, f) for f in fields]
        self._G_fn = torchify(fields + [_T], Gexp, name="G")
        self._dG_fns = [
            torchify(fields + [_T], e, name="dG_d" + str(f))
            for f, e in zip(fields, self.dG_exprs)
        ]
        # signature (fields0..., deltas..., shifted_fields..., t), as in
        # the reference package
        self.delta_symbols = [sy.Symbol("_d_" + str(f)) for f in fields]
        self.shifted_symbols = [sy.Symbol("_s_" + str(f)) for f in fields]
        try:
            self.G_delta_expr = delta_expr(
                Gexp,
                dict(zip(fields, self.delta_symbols)),
                shifted_map=dict(zip(fields, self.shifted_symbols)),
            )
            self._G_delta_fn = torchify_delta(
                fields + self.delta_symbols + self.shifted_symbols + [_T],
                self.G_delta_expr, name="G_delta",
            )
        except UnsupportedDelta:
            self.G_delta_expr = None
            self._G_delta_fn = None

    def _build_ligand_coeffs(self):
        """Per-ligand gamma/s/D as functions of t (TD-aware); their
        sympy expressions of t are also kept in ``lig_exprs`` for the
        kernel code generator."""
        self._lig_coeffs = []
        self.lig_exprs = []
        self._lig_tdep = False
        for lig in self.ps.Vgroups.ligands():
            coeffs, exprs = {}, {}
            for cname, val in (("gamma", lig.gamma), ("s", lig.s), ("D", lig.D)):
                expr, tdep = self._resolve_td(sy.sympify(val))
                exprs[cname] = expr
                if tdep:
                    coeffs[cname] = torchify((_T,), expr, name=cname)
                    self._lig_tdep = True
                else:
                    const = float(expr)
                    coeffs[cname] = lambda t, c=const: c
            self._lig_coeffs.append(coeffs)
            self.lig_exprs.append(exprs)

    def _build_s2(self):
        expr, tdep = self._resolve_td(sy.Symbol("s2"))
        if tdep:
            self._s2_fn = torchify((_T,), expr, name="s2")
        else:
            const = float(expr)
            self._s2_fn = lambda tt, c=const: c

    def stage_delta_ok(self):
        """True when stage RHS evaluations may use the increment form
        (no explicit time dependence in the PDE coefficients)."""
        return (
            self._G_delta_fn is not None
            and not self._G_tdep
            and not self._lig_tdep
        )

    # ------------------------------------------------------------------
    def groom(self, u):
        """Clamp rho >= rhomin, U >= Umin; NaN -> min."""
        rho = u[0]
        rho = torch.where(torch.isnan(rho), self.rhomin, rho)
        rho = torch.clamp(rho, min=self.rhomin)
        Us = u[1:]
        Us = torch.where(torch.isnan(Us), self.Umin, Us)
        Us = torch.clamp(Us, min=self.Umin)
        return torch.cat([rho[None], Us], dim=0)

    def G(self, u, t=None):
        """Pointwise free energy of a (groomed) state tensor."""
        t = self.ps.t0 if t is None else t
        return self._G_fn(*[u[i] for i in range(self.nligands + 1)], t)

    @property
    def reach(self):
        """How many rows beyond a point the RHS and its J-action read:
        ``sw`` for the product-rule rho row (one stencil of pointwise
        fields), ``2*sw`` for the flux form's ``D1_d(rho D1_d G)`` (two
        first-derivative stencils along one axis, each of reach ``sw``
        with nonzero end coefficients).  The stencils are stars: no
        read leaves the point's own row, column or pillar."""
        return 2 * self.sw if self.flux_form else self.sw

    def _add_local_sources(self, out, t, mesh):
        for i, active in enumerate(self._source_active):
            if active:
                out[i] += mesh.local(self.sources[i](t)).to(out.dtype)
        return out

    def rhs(self, u, t, groom=True, mesh=None):
        """du/dt of the full system; u: (dof, *Sshape).

        With a ``mesh`` (parallel/mesh.py SlabMesh) u is this rank's
        block: the RHS reads ``reach`` rows beyond it, so it runs on the
        block padded by its neighbours' halo rows along each padded axis
        (``mesh.pad``) and is cropped back, and the sources add this
        rank's block."""
        if mesh is not None:
            r = self.reach
            out = mesh.crop(self._rhs(mesh.pad(u, r), t, groom, False), r)
            return self._add_local_sources(out.contiguous(), t, mesh)
        return self._rhs(u, t, groom, True)

    def _rhs(self, u, t, groom, sources):
        if groom:
            u = self.groom(u)
        G = self.G(u, t)
        sp, sw = self.spacing, self.sw
        return self._assemble(u, t, self._drho(u[0], grad_apply(G, sp, sw),
                                               G), sources)

    def _drho(self, rho, grad_G, G=None, grad_rho=None, lap_G=None):
        """The rho row without its source: the flux form's sum over the
        axes of D1_d(rho * dG/dx_d) (ksfd_tpu/ops/operators.py:225-230),
        else grad(rho).grad(G) + rho lap(G), from G or from grad(rho)
        and lap(G) given."""
        sp, sw = self.spacing, self.sw
        if self.flux_form:
            drho = None
            for d, gG in enumerate(grad_G):
                div_d = deriv_apply(rho * gG, d, sp, sw)
                drho = div_d if drho is None else drho + div_d
            return drho
        if grad_rho is None:
            grad_rho, lap_G = grad_apply(rho, sp, sw), laplacian_apply(G, sp,
                                                                       sw)
        return sum(gr * gG for gr, gG in zip(grad_rho, grad_G)) + rho * lap_G

    def _assemble(self, u, t, drho, sources):
        """The RHS of the groomed u from its rho row ``drho``."""
        rho = u[0]
        if sources and self._source_active[0]:
            drho = drho + self.sources[0](t).to(drho.dtype)
        outs = [drho]
        for l in range(self.nligands):
            U = u[1 + l]
            c = self._lig_coeffs[l]
            dU = (
                -c["gamma"](t) * U
                + c["s"](t) * rho
                + c["D"](t) * laplacian_apply(U, self.spacing, self.sw)
            )
            if sources and self._source_active[1 + l]:
                dU = dU + self.sources[1 + l](t).to(dU.dtype)
            outs.append(dU)
        return torch.stack(outs, dim=0)

    def dfdt(self, u, t=None):
        """The RHS at t (t0 when None): the reference-compatible name,
        ksfd_tpu/ops/operators.py:dfdt."""
        return self.rhs(u, self.ps.t0 if t is None else t)

    def velocity(self, u, t=None, mesh=None):
        """Worm velocity grad(G) of the groomed state: shape
        (dim, *Sshape).  Counterpart: ksfd_tpu/ops/operators.py:velocity
        (the adaptive chunk's CFL clamp reads it).  With a ``mesh`` u is
        this rank's block, padded by its neighbours' ``sw`` halo rows and
        the result cropped to the block, as ``rhs``."""
        t = self.ps.t0 if t is None else t
        if mesh is not None:
            sw = self.sw
            return mesh.crop(self._velocity(mesh.pad(u, sw), t), sw)
        return self._velocity(u, t)

    def _velocity(self, u, t):
        u = PDEOperators.groom(self, u)
        G = PDEOperators.G(self, u, t)
        return torch.stack(grad_apply(G, self.spacing, self.sw), dim=0)

    def jacobian_action(self, u, t, v, groom=True):
        """Exact Jacobian-vector product d(rhs)/du @ v via
        torch.func.jvp (counterpart of jax.jvp)."""
        _, jv = torch.func.jvp(
            lambda uu: self.rhs(uu, t, groom=groom), (u,), (v,)
        )
        return jv

    def linearize(self, u, t, primal=True, mesh=None):
        """``(rhs(u, t), v -> J(u) v)``, the RHS and its exact J-action
        at u, the counterpart of ``jax.linearize(lambda uu: ops.rhs(uu,
        t), u)`` (ksfd_tpu/solvers/solver.py:400, :554-558) by the
        product rule of the discretization: with the groomed fields, G,
        its stencils and every dG/dfield evaluated once here, an apply
        is

            J_rho v = grad(v_rho).grad(G) + grad(rho).grad(Gv)
                      + v_rho*lap(G) + rho*lap(Gv),  Gv = sum_i dG_i v_i
            J_Ul v  = -gamma_l v_Ul + s_l v_rho + D_l lap(v_Ul)

        on the tangent through the clamp: 1 above the floor, 0 below
        it or at a NaN, 1/2 at the floor itself (the derivative of the
        reference's ``jnp.maximum`` at a tie).  In the flux form the rho
        row is ``sum_d D1_d(v_rho dG/dx_d + rho dGv/dx_d)``.  Stencils,
        no pointwise transcendental, per apply.  Forward-mode AD of the RHS
        (``torch.func.jvp``, ``torch.func.linearize``) costs far more
        host time per apply: PERF.md section 6.

        The RHS comes from the same groomed fields, G and stencils;
        ``primal=False`` returns None in its place (the mixed path's
        float32 W needs only the J-action).

        With a ``mesh`` (parallel/mesh.py SlabMesh) u is this rank's
        block: it is padded once here with its neighbours' ``reach``
        halo rows (``mesh.pad``), each v in every apply, and the block's
        own points are cut back, as ``rhs(mesh=)`` does; the sources add
        this rank's block.  The unfused step and the float64 GMRES W
        apply on a mesh use it, where the reference linearizes its
        sharded array with ``jax.linearize``."""
        if mesh is not None:
            r = self.reach
            f0, jvp_pad = self._linearize(mesh.pad(u, r), t, primal, False)
            if f0 is not None:
                f0 = self._add_local_sources(mesh.crop(f0, r).contiguous(),
                                             t, mesh)

            def jvp_slab(v):
                return mesh.crop(jvp_pad(mesh.pad(v, r)), r)

            return f0, jvp_slab
        return self._linearize(u, t, primal, True)

    def _linearize(self, u, t, primal, sources):
        ug = self.groom(u)
        nf = self.nligands + 1
        fields = [ug[i] for i in range(nf)]
        rho = fields[0]
        G = self._G_fn(*fields, t)
        dGs = [fn(*fields, t) for fn in self._dG_fns]
        sp, sw = self.spacing, self.sw
        grad_G = grad_apply(G, sp, sw)
        flux = self.flux_form
        grad_rho = None if flux else grad_apply(rho, sp, sw)
        lap_G = None if flux else laplacian_apply(G, sp, sw)
        f0 = (self._assemble(ug, t, self._drho(rho, grad_G, G, grad_rho,
                                               lap_G), sources)
              if primal else None)
        floors = [self.rhomin] + [self.Umin] * self.nligands
        slopes = [torch.where(u[i] > lo, 1.0,
                              torch.where(u[i] == lo, 0.5, 0.0)).to(u.dtype)
                  for i, lo in enumerate(floors)]
        coeffs = [(c["gamma"](t), c["s"](t), c["D"](t))
                  for c in self._lig_coeffs]

        def jvp(v):
            vm = [slopes[i] * v[i] for i in range(nf)]
            Gv = dGs[0] * vm[0]
            for i in range(1, nf):
                Gv = Gv + dGs[i] * vm[i]
            grad_Gv = grad_apply(Gv, sp, sw)
            if flux:
                drho = None
                for d, (gG, gGv) in enumerate(zip(grad_G, grad_Gv)):
                    div_d = deriv_apply(vm[0] * gG + rho * gGv, d, sp, sw)
                    drho = div_d if drho is None else drho + div_d
            else:
                grad_v = grad_apply(vm[0], sp, sw)
                drho = (sum(a * b for a, b in zip(grad_v, grad_G))
                        + sum(a * b for a, b in zip(grad_rho, grad_Gv))
                        + vm[0] * lap_G + rho * laplacian_apply(Gv, sp, sw))
            rows = [drho]
            for l, (gamma, s, D) in enumerate(coeffs):
                rows.append(-gamma * vm[1 + l] + s * vm[0]
                            + D * laplacian_apply(vm[1 + l], sp, sw))
            return torch.stack(rows, dim=0)

        return f0, jvp

    # ------------------------------------------------------------------
    def stiff_coefficients(self, t):
        """(diffusion, decay) per field for the spectral preconditioner."""
        diff = [self._s2_fn(t)]
        decay = [0.0]
        for c in self._lig_coeffs:
            diff.append(c["D"](t))
            decay.append(c["gamma"](t))
        return diff, decay

    def laplacian_symbol(self):
        """The DFT eigenvalues of the discrete Laplacian on this grid
        (ops/stencil.py laplacian_symbol).  Counterpart:
        ksfd_tpu/ops/operators.py:laplacian_symbol."""
        return _laplacian_symbol(self.grid.nps, self.spacing, self.sw)

    def linearization_coefficients(self, means, t):
        """Mean-state linearization data for the block preconditioner:
        (dG, s, gamma, D), dG[i] = dG/dfield_i at the means."""
        dG = [fn(*means, t) for fn in self._dG_fns]
        s = [c["s"](t) for c in self._lig_coeffs]
        gamma = [c["gamma"](t) for c in self._lig_coeffs]
        D = [c["D"](t) for c in self._lig_coeffs]
        return dG, s, gamma, D
