"""Spectral preconditioners for the implicit stage solves.

Counterpart: ksfd_tpu/solvers/linalg.py:SpectralPreconditioner and
:BlockSpectralPreconditioner, in their basis-GEMM form, 1D, 2D and 3D.
On the periodic uniform grid the discrete Laplacian is diagonalized
exactly by the orthonormal real-DFT basis (ops/stencil.py
real_dft_basis), so a transform is ``v @ Qx`` per field in 1D,
``Qx^T @ v @ Qy`` in 2D and its inverse ``c @ Qx^T`` or ``Qx @ c @
Qy^T`` — plain matrix products, which the
reference leaves to XLA and the port leaves to ``torch.matmul``.  In 3D
the reference's four-operand einsums (``"fijm,ik,jl,mn->fkln"`` and
``"fkln,ik,jl,mn->fijm"``) are written as three single-axis products,
last axis first, so no intermediate is larger than the state.  The
per-mode arrow solve between them is elementwise tensor arithmetic (XLA
code in the reference too, ``_arrow_solve``).  Behind ``-pc_pallas 1``
the whole 2D apply is the hand-written CUDA pair of ops/fused_pc.py
instead.

The transforms run in the compute dtype (float32 by default, as
``pc_dtype`` auto resolves on one device).  On the card a float32
product must run in full float32: the caller keeps
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default;
chip_smoke.py sets and records it).

On a slab mesh (parallel/mesh.py) the apply is
``make_sharded_block_apply``, the counterpart of linalg.py:295: the
forward products contract only this rank's x rows, the partial mode
coefficients are cast to the transform dtype and summed over the ranks
in ONE all_reduce per apply, the arrow solve runs replicated, and the
inverse products give only the local rows.  There ``pc_dtype``
bfloat16 (the default on more than one rank) runs the transforms on
bfloat16 operands and stores their intermediates and the reduced
coefficients in bfloat16, the mode arithmetic and the inverse products
in float32; bfloat16 runs in no other apply.
Not ported yet: the FFT form (``pc_fft``, ROADMAP Queue A item 8, A4).
"""

import torch
from torch import nn

from ..ops.stencil import laplacian_eigendecomp
from ..parallel.mesh import all_reduce_sum
from ..utils.device import resolve_device

__all__ = ["SpectralPreconditioner", "BlockSpectralPreconditioner",
           "make_sharded_block_apply"]

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "f32": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


class SpectralPreconditioner(nn.Module):
    """M^{-1} for W = shift*I - J, inverting each field's stiff part
    ``decay_f - diff_f * Laplacian`` exactly per Fourier mode.

    Counterpart: ksfd_tpu/solvers/linalg.py:SpectralPreconditioner.
    Buffers: ``Qx``, ``Qy`` (and ``Qz`` in 3D), the per-axis bases;
    ``lam``, the total Laplacian eigenvalue per mode (<= 0, float64,
    shape ``grid.Sshape``); and ``lam_cd``, the same values in the
    compute dtype (not saved: it follows ``lam`` on load), so an apply
    does not re-cast the whole mode array.  Buffers live on ``device``,
    the card unless given (utils/device.py).
    """

    def __init__(self, grid, compute_dtype=None, device=None):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise NotImplementedError("pc dtype %r" % (compute_dtype,))
        device = resolve_device(device)
        td = _DTYPES[compute_dtype]
        # bfloat16: bf16 transforms (the bases stored so), f32 modes
        cd = torch.float32 if td == torch.bfloat16 else td
        self.transform_dtype = td
        self.compute_dtype = cd
        self.dim = grid.dim
        self.sshape = tuple(grid.Sshape)
        sw = grid.stencil_width
        lam = None
        for d, name in enumerate(("Qx", "Qy", "Qz")[: grid.dim]):
            Q, ld = laplacian_eigendecomp(
                int(grid.nps[d]), float(grid.spacing[d]), sw
            )
            self.register_buffer(
                name, torch.as_tensor(Q, dtype=td, device=device)
            )
            # total eigenvalue per mode: lam_x (+ lam_y (+ lam_z))
            lam = ld if lam is None else lam[..., None] + ld
        # lam stays float64 like the reference's numpy total
        self.register_buffer(
            "lam", torch.as_tensor(lam, dtype=torch.float64, device=device)
        )
        self.register_buffer("lam_cd", self.lam.to(cd), persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module._sync_lam_cd()
        )

    def _sync_lam_cd(self):
        self.lam_cd = self.lam.to(self.compute_dtype)

    def _unsharded(self):
        if self.transform_dtype == torch.bfloat16:
            raise NotImplementedError(
                "bfloat16 transforms run only in the sharded apply "
                "(make_sharded_block_apply, on a slab mesh)")

    def _forward(self, v):
        """(dof, *Sshape) -> real spectral coefficients: v Qx in 1D
        ("fi,ik->fk"), Qx^T v Qy in 2D, "fijm,ik,jl,mn->fkln" in 3D."""
        self._unsharded()
        if self.dim == 1:
            return torch.matmul(v, self.Qx)
        if self.dim == 2:
            return torch.matmul(torch.matmul(self.Qx.T, v), self.Qy)
        f, nx, ny, nz = v.shape
        c = torch.matmul(v, self.Qz)               # m -> n
        c = torch.matmul(self.Qy.T, c)             # j -> l
        c = torch.matmul(self.Qx.T, c.reshape(f, nx, ny * nz))  # i -> k
        return c.reshape(f, nx, ny, nz)

    def _inverse(self, c):
        """The inverse transform: c Qx^T in 1D ("fk,ik->fi"), Qx c Qy^T
        in 2D, "fkln,ik,jl,mn->fijm" in 3D."""
        if self.dim == 1:
            return torch.matmul(c, self.Qx.T)
        if self.dim == 2:
            return torch.matmul(torch.matmul(self.Qx, c), self.Qy.T)
        f, nx, ny, nz = c.shape
        v = torch.matmul(c, self.Qz.T)             # n -> m
        v = torch.matmul(self.Qy, v)               # l -> j
        v = torch.matmul(self.Qx, v.reshape(f, nx, ny * nz))    # k -> i
        return v.reshape(f, nx, ny, nz)

    def apply(self, v, shift, diff, decay):
        """v: (dof, *Sshape); diff/decay: per-field scalars."""
        cd = self.compute_dtype
        c = self._forward(v.to(cd))
        dev = v.device
        per_field = (-1,) + (1,) * self.dim
        diff = torch.stack([torch.as_tensor(d, dtype=cd, device=dev) for d in diff])
        decay = torch.stack([torch.as_tensor(d, dtype=cd, device=dev) for d in decay])
        denom = (
            torch.as_tensor(shift, dtype=cd, device=dev)
            + decay.reshape(per_field)
            - diff.reshape(per_field) * self.lam_cd
        )
        return self._inverse(c / denom).to(v.dtype)


class BlockSpectralPreconditioner(SpectralPreconditioner):
    """Per-mode exact inverse of the mean-state linearization.

    Counterpart: ksfd_tpu/solvers/linalg.py:BlockSpectralPreconditioner.
    Per Fourier mode (Laplacian eigenvalue lam <= 0) the (dof x dof)
    matrix

        W(lam) = shift*I - J(lam),
        J_rho,i(lam) = rho_mean * lam * dG/dfield_i |_means
        J_Ul,rho = s_l,   J_Ul,Ul = -gamma_l + D_l*lam

    is an arrow matrix, solved in closed form by a Schur complement on
    the rho row; the rho row's diffusivity is the pointwise bound
    ``rho_diff`` = max_x(rho * dG/drho) when given.
    """

    def __init__(self, grid, ops, compute_dtype=None, device=None):
        super().__init__(grid, compute_dtype=compute_dtype, device=device)
        self.ops = ops
        self.nfields = ops.nligands + 1

    def _arrow_solve(self, c, shift, t, means, rho_diff):
        """Per-mode arrow-system solve on transformed coefficients c
        (counterpart: BlockSpectralPreconditioner._arrow_solve)."""
        cd = self.compute_dtype
        dev = c.device
        cast = lambda x: torch.as_tensor(x, dtype=cd, device=dev)
        nf = self.nfields
        lam = self.lam_cd
        dG, s, gamma, D = self.ops.linearization_coefficients(means, t)
        rho_mean = cast(means[0])
        shift = cast(shift)
        dG = [cast(g) for g in dG]
        # arrow system per mode:
        #   a x_r + sum_l b_l x_l = y_r
        #   c_l x_r + d_l x_l     = y_l
        if rho_diff is not None:
            a = shift - cast(rho_diff) * lam
        else:
            a = shift - rho_mean * lam * dG[0]
        schur = a
        rhs_r = c[0]
        xs_den = []
        for l in range(nf - 1):
            b_l = -rho_mean * lam * dG[1 + l]
            c_l = -cast(s[l])
            d_l = shift + cast(gamma[l]) - cast(D[l]) * lam
            schur = schur - b_l * c_l / d_l
            rhs_r = rhs_r - b_l * c[1 + l] / d_l
            xs_den.append((c_l, d_l))
        x_r = rhs_r / schur
        outs = [x_r]
        for l in range(nf - 1):
            c_l, d_l = xs_den[l]
            outs.append((c[1 + l] - c_l * x_r) / d_l)
        return torch.stack(outs, dim=0)

    def apply_linearized(self, v, shift, t, means, rho_diff=None):
        """v: (dof, *Sshape); means: per-field scalars of the STATE
        being linearized (not of v, which is a residual).  Returns the
        result in v's dtype."""
        if v.shape[0] != self.nfields:
            raise NotImplementedError(
                "extra trailing fields (the with-G state) are ROADMAP "
                "Queue A item 10 (A13)"
            )
        c = self._forward(v.to(self.compute_dtype))
        outs = self._arrow_solve(c, shift, t, means, rho_diff)
        return self._inverse(outs).to(v.dtype)


def make_sharded_block_apply(precond, ops, mesh):
    """The block pc's apply on a slab mesh, ONE all_reduce per apply:
    ``apply(v, shift, t, means, rho_diff)`` with v this rank's slab.

    Counterpart: ksfd_tpu/solvers/linalg.py:make_sharded_block_apply.
    The forward products contract only the local x rows against this
    rank's rows of Qx (the local y (and z) products first, so each
    rank's work is its share); the partial mode coefficients are cast to
    the transform dtype (bfloat16 on the wire under ``pc_dtype``
    bfloat16: the forward products' operands and outputs are bf16) and
    summed over the ranks; the arrow solve runs replicated in the
    compute dtype; the inverse products give only the local rows, in
    the compute dtype from the transform-dtype coefficients and bases
    (the reference's ``preferred_element_type=cd``: a bf16 pc rounds
    none of its inverse's intermediates to bf16), with no further
    collective.  The products are plain ``torch.matmul``, as the
    single-card pc's are.
    """
    td, cd = precond.transform_dtype, precond.compute_dtype
    dim = precond.dim
    qx = mesh.rows(precond.Qx).contiguous()        # (nx_loc, nx), td
    qxT = qx.T.contiguous()
    last = precond.Qz if dim == 3 else precond.Qy
    Qy = precond.Qy
    # the inverse's operands: the td-rounded bases and coefficients, its
    # products and their outputs in cd (a bf16 x bf16 product is exact
    # in f32), as the reference's preferred_element_type=cd inverse
    qx_i = qx.to(cd)
    Qy_i = Qy.to(cd)
    lastT_i = last.T.to(cd).contiguous()

    def forward(v):
        f, nloc = v.shape[0], v.shape[1]
        c = torch.matmul(v.to(td), last)                  # m -> n (y in 2D)
        if dim == 3:
            c = torch.matmul(Qy.T, c)                     # j -> l
        c = torch.matmul(qxT, c.reshape(f, nloc, -1))     # local i -> k
        return c.reshape((f, mesh.nx) + tuple(v.shape[2:]))

    def inverse(c):
        f, rest = c.shape[0], tuple(c.shape[2:])
        c = c.to(td).to(cd).reshape(f, mesh.nx, -1)
        o = torch.matmul(qx_i, c)                         # k -> local i
        o = o.reshape((f, mesh.nx_loc) + rest)
        if dim == 3:
            o = torch.matmul(Qy_i, o)                     # l -> j
        return torch.matmul(o, lastT_i)                   # n -> m

    def apply(v, shift, t, means, rho_diff):
        if v.shape[0] != precond.nfields:
            raise NotImplementedError(
                "extra trailing fields (the with-G state) are ROADMAP "
                "Queue A item 10 (A13)")
        # THE collective: the partial coefficients, in the transform dtype
        c = all_reduce_sum(forward(v).to(td), mesh)
        outs = precond._arrow_solve(c.to(cd), shift, t, means, rho_diff)
        return inverse(outs).to(v.dtype)

    return apply
