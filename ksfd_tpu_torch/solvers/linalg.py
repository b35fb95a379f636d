"""Spectral preconditioners for the implicit stage solves.

Counterpart: ksfd_tpu/solvers/linalg.py:SpectralPreconditioner and
:BlockSpectralPreconditioner, 1D, 2D and 3D, in both of their forms.
On the periodic uniform grid the discrete Laplacian is diagonalized
exactly by the orthonormal real-DFT basis (ops/stencil.py
real_dft_basis), so the **basis-GEMM form**'s transform is ``v @ Qx``
per field in 1D, ``Qx^T @ v @ Qy`` in 2D and its inverse ``c @ Qx^T``
or ``Qx @ c @ Qy^T`` — plain matrix products, which the reference
leaves to XLA and the port leaves to ``torch.matmul``.  In 3D the
reference's four-operand einsums (``"fijm,ik,jl,mn->fkln"`` and
``"fkln,ik,jl,mn->fijm"``) are written as three single-axis products,
so no intermediate is larger than the state.  The per-mode arrow solve
between them is elementwise tensor arithmetic (XLA code in the
reference too, ``_arrow_solve``).  Behind ``-pc_pallas 1`` the whole 2D
apply is the hand-written CUDA pair of ops/fused_pc.py instead.

The **FFT form** (``use_fft``, ``-pc_fft``) applies the same circulant
inverse through ``torch.fft.rfftn``/``irfftn`` over the field axes:
complex64 coefficients on the rfft shape, ``lam`` the discrete
stencil's exact symbol there (ops/stencil.py laplacian_symbol).  As the
reference's, it is float32 whatever ``pc_dtype`` asks (its clamp,
linalg.py:110-125).

The transforms run in the transform dtype, ``pc_dtype`` (float32 by
default, as ``pc_dtype`` auto resolves on one device).  bfloat16, on
one card or on a mesh, runs the forward products on bfloat16 operands
and stores their intermediates and the mode coefficients in bfloat16;
the mode arithmetic, and the inverse products from the bf16-rounded
coefficients and bases, run in float32, so the final inverse output is
float32 (the reference's ``preferred_element_type``: a bf16 x bf16
product is exact in float32).  On the card a float32 product must run
in full float32: the caller keeps
``torch.backends.cuda.matmul.allow_tf32`` False (PyTorch's default;
chip_smoke.py sets and records it).

On a slab mesh (parallel/mesh.py) the apply is
``make_sharded_block_apply``, the counterpart of linalg.py:295, on the
same products (``forward_products``, ``inverse_products``) with this
rank's rows of Qx: the partial mode coefficients are cast to the
transform dtype and summed over the ranks in ONE all_reduce per apply,
the arrow solve runs replicated, and the inverse products give only
the local rows.  The FFT form is single-card only, as the reference's
is (an FFT along the split axis would gather).
"""

import torch
from torch import nn

from ..ops.stencil import laplacian_eigendecomp, laplacian_symbol
from ..parallel.mesh import all_reduce_sum
from ..utils.device import resolve_device

__all__ = ["SpectralPreconditioner", "BlockSpectralPreconditioner",
           "make_sharded_block_apply", "forward_products",
           "inverse_products"]

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "f32": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def forward_products(v, qx, qy=None, qz=None, slab=False, nx=None):
    """The forward basis transform of ``v`` (dof, nx, ...) against the
    per-axis bases: ``v qx`` in 1D, ``(qx^T v) qy`` in 2D, and in 3D the
    last axis first (``v qz``, then ``qy^T``, then ``qx^T``).  With
    ``slab`` v holds a rank's x rows and ``qx`` (rows, nx) its rows of
    the x basis: the x contraction comes last (in 2D ``qx^T (v qy)``),
    and ``nx`` is the global extent.  The products run in the operands'
    dtype, so bfloat16 operands give bfloat16 intermediates and
    coefficients."""
    if qy is None:
        return torch.matmul(v, qx)
    if qz is None:
        if slab:
            return torch.matmul(qx.T, torch.matmul(v, qy))
        return torch.matmul(torch.matmul(qx.T, v), qy)
    f, rows = v.shape[0], v.shape[1]
    nx = qx.shape[1] if nx is None else nx
    c = torch.matmul(v, qz)                                   # m -> n
    c = torch.matmul(qy.T, c)                                 # j -> l
    c = torch.matmul(qx.T, c.reshape(f, rows, -1))            # i -> k
    return c.reshape((f, nx) + tuple(v.shape[2:]))


def inverse_products(c, qx, qy=None, qz=None, slab=False):
    """The inverse basis transform of the mode coefficients ``c`` (dof,
    nx, ...): ``c qx^T`` in 1D, ``(qx c) qy^T`` in 2D, and in 3D the last
    axis first (``qz^T``, then ``qy``, then ``qx``), in the operands'
    dtype.  With ``slab`` ``qx`` (rows, nx) holds a rank's rows of the x
    basis and the x product comes first, giving only those rows."""
    if qy is None:
        return torch.matmul(c, qx.T)
    if qz is None:
        return torch.matmul(torch.matmul(qx, c), qy.T)
    f, rest = c.shape[0], tuple(c.shape[2:])
    if not slab:
        o = torch.matmul(c, qz.T)                             # n -> m
        o = torch.matmul(qy, o)                               # l -> j
        o = torch.matmul(qx, o.reshape(f, c.shape[1], -1))    # k -> i
        return o.reshape(c.shape)
    o = torch.matmul(qx, c.reshape(f, c.shape[1], -1))        # k -> i
    o = o.reshape((f, qx.shape[0]) + rest)
    o = torch.matmul(qy, o)                                   # l -> j
    return torch.matmul(o, qz.T)                              # n -> m


class SpectralPreconditioner(nn.Module):
    """M^{-1} for W = shift*I - J, inverting each field's stiff part
    ``decay_f - diff_f * Laplacian`` exactly per Fourier mode.

    Counterpart: ksfd_tpu/solvers/linalg.py:SpectralPreconditioner.
    Buffers of the basis-GEMM form: ``Qx``, ``Qy`` (and ``Qz`` in 3D),
    the per-axis bases in the transform dtype (with bfloat16 also
    ``Qx_cd`` etc., the same bf16 values in float32, for the inverse);
    ``lam``, the total Laplacian eigenvalue per mode (<= 0, float64,
    shape ``grid.Sshape``).  The FFT form (``use_fft``) has no basis and
    ``lam`` on the rfft shape in float32, as the reference's.
    ``lam_cd`` holds ``lam`` in the compute dtype (not saved: it follows
    ``lam`` on load), so an apply does not re-cast the whole mode array.
    Buffers live on ``device``, the card unless given (utils/device.py).
    """

    def __init__(self, grid, compute_dtype=None, device=None, use_fft=False):
        super().__init__()
        if compute_dtype not in _DTYPES:
            raise NotImplementedError("pc dtype %r" % (compute_dtype,))
        device = resolve_device(device)
        td = _DTYPES[compute_dtype]
        # bfloat16: bf16 transforms (the bases stored so), f32 modes
        cd = torch.float32 if td == torch.bfloat16 else td
        self.use_fft = bool(use_fft)
        self.transform_dtype = td
        self.dim = grid.dim
        self.sshape = tuple(grid.Sshape)
        sw = grid.stencil_width
        self._bases = ("Qx", "Qy", "Qz")[: grid.dim]
        if self.use_fft:
            # float32 whatever pc_dtype asks (the reference's clamp)
            cd = torch.float32
            self._bases = ()
            lam = torch.as_tensor(laplacian_symbol(
                [int(n) for n in grid.nps],
                [float(s) for s in grid.spacing], sw), dtype=cd)
        else:
            lam = None
            for d, name in enumerate(self._bases):
                Q, ld = laplacian_eigendecomp(
                    int(grid.nps[d]), float(grid.spacing[d]), sw
                )
                self.register_buffer(
                    name, torch.as_tensor(Q, dtype=td, device=device)
                )
                if td != cd:
                    self.register_buffer(
                        name + "_cd", getattr(self, name).to(cd),
                        persistent=False)
                # total eigenvalue per mode: lam_x (+ lam_y (+ lam_z))
                lam = ld if lam is None else lam[..., None] + ld
            # lam stays float64 like the reference's numpy total
            lam = torch.as_tensor(lam, dtype=torch.float64)
        self.compute_dtype = cd
        self.register_buffer("lam", lam.to(device))
        self.register_buffer("lam_cd", self.lam.to(cd), persistent=False)
        self.register_load_state_dict_post_hook(
            lambda module, keys: module._sync_cd()
        )

    def _sync_cd(self):
        self.lam_cd = self.lam.to(self.compute_dtype)
        if self.transform_dtype != self.compute_dtype:
            for name in self._bases:
                setattr(self, name + "_cd",
                        getattr(self, name).to(self.compute_dtype))

    def _fft_axes(self):
        return tuple(range(1, 1 + self.dim))

    def _forward(self, v):
        """(dof, *Sshape) -> spectral coefficients: complex64 rfftn
        coefficients in the FFT form; else real coefficients of v's
        shape in the transform dtype (forward_products)."""
        if self.use_fft:
            return torch.fft.rfftn(v.to(torch.float32), dim=self._fft_axes())
        return forward_products(
            v.to(self.transform_dtype),
            *(getattr(self, name) for name in self._bases))

    def _inverse(self, c):
        """The inverse transform, in the compute dtype: irfftn in the FFT
        form, else inverse_products on the coefficients rounded to the
        transform dtype (a bf16 pc rounds none of the inverse's
        intermediates to bf16)."""
        if self.use_fft:
            return torch.fft.irfftn(c, s=self.sshape, dim=self._fft_axes())
        td, cd = self.transform_dtype, self.compute_dtype
        sfx = "" if td == cd else "_cd"
        return inverse_products(
            c.to(td).to(cd),
            *(getattr(self, name + sfx) for name in self._bases))

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

    def __init__(self, grid, ops, compute_dtype=None, device=None,
                 use_fft=False):
        super().__init__(grid, compute_dtype=compute_dtype, device=device,
                         use_fft=use_fft)
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
    The forward products (``forward_products``) contract only the local
    x rows against this rank's rows of Qx (the local y (and z) products
    first, so each rank's work is its share); the partial mode
    coefficients are cast to the transform dtype (bfloat16 on the wire
    under ``pc_dtype`` bfloat16) and summed over the ranks; the arrow
    solve runs replicated in the compute dtype; the inverse products
    (``inverse_products``) give only the local rows, in the compute
    dtype from the transform-dtype coefficients and bases, as the
    single-card apply's, with no further collective.  The FFT form
    raises: it is single-card only (the reference's sharded apply also
    excludes it).
    """
    if precond.use_fft:
        raise NotImplementedError(
            "not ported yet (see ROADMAP): the FFT pc on a mesh (the "
            "reference's is single-shard too), Queue A item 11 (A14)")
    td, cd = precond.transform_dtype, precond.compute_dtype
    rest = precond._bases[1:]
    qx = mesh.rows(precond.Qx).contiguous()        # (nx_loc, nx), td
    fwd = [getattr(precond, name) for name in rest]
    # the inverse's operands: the td-rounded bases in cd (exact)
    qx_i = qx.to(cd)
    inv = [getattr(precond, name).to(cd) for name in rest]

    def apply(v, shift, t, means, rho_diff):
        if v.shape[0] != precond.nfields:
            raise NotImplementedError(
                "extra trailing fields (the with-G state) are ROADMAP "
                "Queue A item 10 (A13)")
        c = forward_products(v.to(td), qx, *fwd, slab=True, nx=mesh.nx)
        # THE collective: the partial coefficients, in the transform dtype
        c = all_reduce_sum(c.to(td), mesh)
        outs = precond._arrow_solve(c.to(cd), shift, t, means, rho_diff)
        return inverse_products(outs.to(td).to(cd), qx_i, *inv,
                                slab=True).to(v.dtype)

    return apply
