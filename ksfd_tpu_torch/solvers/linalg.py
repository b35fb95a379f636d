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
between them (XLA elementwise code in the reference, ``_arrow_solve``)
is, on the card, one launch of the hand-written kernel of csrc/arrow.cu
(``arrow_modes``, float32 or float64 modes, any dimension, a member axis
under ``torch.func.vmap``), and elsewhere the same arithmetic as plain
tensor operations (``_arrow_chain``): the CPU, the FFT form's complex
modes and the bfloat16 coefficients of a single-card bfloat16 pc.  The
kernel rounds every operation on its own in the plain chain's order, so
the two agree bit for bit.  Both read the per-step scalar pack
(``BlockSpectralPreconditioner.pack``, built on the device with no
host copy), so an application synchronises nothing.  Behind
``-pc_pallas 1`` the whole 2D apply is the hand-written CUDA pair of
ops/fused_pc.py instead.

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

On a mesh (parallel/mesh.py) the apply of the block and of the
spectral pc is ``make_sharded_apply``, the counterpart of
linalg.py:295, on the same products (``forward_products``,
``inverse_products``) with this rank's rows of each split axis's basis:
the partial mode coefficients are cast to the transform dtype and
summed over the ranks in ONE all_reduce per apply, the per-mode solve
runs replicated, and the inverse products give only the local block.
The FFT form gathers the state there, as XLA gathers for the
reference's (an FFT along a split axis); a transpose-based distributed
FFT is later speed work (ROADMAP).
"""

import ctypes
from pathlib import Path

import torch
from torch import nn

from ..ops.fused_pc import PCKernel, _PCBuild, ligand_table, pack_pc_scalars
from ..ops.stencil import laplacian_eigendecomp, laplacian_symbol
from ..parallel.mesh import all_reduce_sum
from ..utils.device import resolve_device

__all__ = ["SpectralPreconditioner", "BlockSpectralPreconditioner",
           "make_sharded_apply", "forward_products", "inverse_products"]

CSRC_ARROW = Path(__file__).resolve().parent.parent / "csrc" / "arrow.cu"
_P, _I = ctypes.c_void_p, ctypes.c_int
#: (pack, P, modes, lam, out, nl, nextra, S, nb, dbl, stream)
ARROW_BUILD = _PCBuild(CSRC_ARROW, {
    "ksfd_arrow_modes": [_P, _I, _P, _P, _P, _I, _I, ctypes.c_longlong,
                         _I, _I, _P]})

_DTYPES = {
    None: torch.float32,
    "float32": torch.float32,
    "f32": torch.float32,
    "float64": torch.float64,
    "f64": torch.float64,
    "bfloat16": torch.bfloat16,
    "bf16": torch.bfloat16,
}


def forward_products(v, qx, qy=None, qz=None, slab=False):
    """The forward basis transform of ``v`` (dof, nx, ...) against the
    per-axis bases: ``v qx`` in 1D, ``(qx^T v) qy`` in 2D, and in 3D the
    last axis first (``v qz``, then ``qy^T``, then ``qx^T``).  With
    ``slab`` v holds a rank's block and each basis (rows, n) its rows of
    that axis's basis (all of them on an unsplit axis): the x
    contraction comes last (in 2D ``qx^T (v qy)``).  The products run
    in the operands' dtype, so bfloat16 operands give bfloat16 intermediates and
    coefficients."""
    if qy is None:
        return torch.matmul(v, qx)
    if qz is None:
        if slab:
            return torch.matmul(qx.T, torch.matmul(v, qy))
        return torch.matmul(torch.matmul(qx.T, v), qy)
    f, rows = v.shape[0], v.shape[1]
    c = torch.matmul(v, qz)                                   # m -> n
    c = torch.matmul(qy.T, c)                                 # j -> l
    rest = tuple(c.shape[2:])
    c = torch.matmul(qx.T, c.reshape(f, rows, -1))            # i -> k
    return c.reshape((f, qx.shape[1]) + rest)


def inverse_products(c, qx, qy=None, qz=None, slab=False):
    """The inverse basis transform of the mode coefficients ``c`` (dof,
    nx, ...): ``c qx^T`` in 1D, ``(qx c) qy^T`` in 2D, and in 3D the last
    axis first (``qz^T``, then ``qy``, then ``qx``), in the operands'
    dtype.  With ``slab`` each basis (rows, n) holds a rank's rows of
    its axis's basis and the x product comes first, giving only the
    rank's block."""
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

    def _denom(self, c, shift, diff, decay):
        """``shift + decay_f - diff_f lam`` per field and mode, in the
        compute dtype on c's device."""
        cd = self.compute_dtype
        dev = c.device
        per_field = (-1,) + (1,) * self.dim
        diff = torch.stack([torch.as_tensor(d, dtype=cd, device=dev) for d in diff])
        decay = torch.stack([torch.as_tensor(d, dtype=cd, device=dev) for d in decay])
        return (
            torch.as_tensor(shift, dtype=cd, device=dev)
            + decay.reshape(per_field)
            - diff.reshape(per_field) * self.lam_cd
        )

    def apply(self, v, shift, diff, decay):
        """v: (dof, *Sshape); diff/decay: per-field scalars."""
        c = self._forward(v.to(self.compute_dtype))
        return self._inverse(c / self._denom(c, shift, diff, decay)).to(
            v.dtype)


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
        #: the pack's constant ligand coefficients, on the device once
        self.ligands = ligand_table(ops, self.compute_dtype,
                                    self.lam_cd.device)
        #: the arrow solve's kernel: real float32 or float64 modes on the
        #: card (``launches`` counts its calls), None in the FFT form
        self.arrow = None
        if not self.use_fft and self.compute_dtype in (torch.float32,
                                                       torch.float64):
            self.arrow = _ArrowKernel(
                "arrow_modes", self._arrow_chain, self._launch_arrow, 1,
                "ksfd_tpu/solvers/linalg.py:BlockSpectralPreconditioner"
                "._arrow_solve")

    def pack(self, shift, t, means, rho_diff=None):
        """The per-step scalar pack of ``apply_packed``: fused_pc.py's
        ``pack_pc_scalars`` layout in the compute dtype on the pc's
        device, ``[shift, rho_diff, rho_mean, dG_1..dG_nl, s_1..s_nl,
        gamma_1..gamma_nl, D_1..D_nl]`` (``rho_diff`` None: ``rho_mean
        dG_0`` at the means).  ``means`` are per-field scalars of the
        STATE being linearized, ``t`` its time; built with no copy from
        the host."""
        return pack_pc_scalars(self.ops, shift, t, means, rho_diff,
                               self.ligands)

    def _arrow_chain(self, pack, c):
        """Per-mode arrow-system solve on transformed coefficients c
        (counterpart: BlockSpectralPreconditioner._arrow_solve) as plain
        tensor operations; each field past the physical ones (a with-G
        state's G) gets the shift-only inverse ``c / shift``."""
        nf = self.nfields
        nl = nf - 1
        lam = self.lam_cd
        shift, rho_mean = pack[0], pack[2]
        # arrow system per mode, a = shift - rho_diff lam:
        #   a x_r + sum_l b_l x_l = y_r
        #   c_l x_r + d_l x_l     = y_l
        schur = shift - pack[1] * lam
        rhs_r = c[0]
        xs_den = []
        for l in range(nl):
            b_l = -rho_mean * lam * pack[3 + l]
            c_l = -pack[3 + nl + l]
            d_l = shift + pack[3 + 2 * nl + l] - pack[3 + 3 * nl + l] * lam
            schur = schur - b_l * c_l / d_l
            rhs_r = rhs_r - b_l * c[1 + l] / d_l
            xs_den.append((c_l, d_l))
        x_r = rhs_r / schur
        outs = [x_r]
        for l in range(nl):
            c_l, d_l = xs_den[l]
            outs.append((c[1 + l] - c_l * x_r) / d_l)
        for extra in range(nf, c.shape[0]):
            outs.append(c[extra] / shift)
        return torch.stack(outs, dim=0)

    def _launch_arrow(self, pack, c):
        """``arrow_modes`` on the card: c ``(nf + nextra, *Sshape)`` or
        with a leading member axis, the pack ``(P,)`` or ``(nb, P)``, lam
        shared; a new output."""
        lam = self.lam_cd
        batched = c.dim() == lam.dim() + 2
        nb = int(c.shape[0]) if batched else 1
        nl = self.nfields - 1
        P = 3 + 4 * nl
        if (c.dtype != lam.dtype or pack.dtype != lam.dtype
                or c.device != lam.device or pack.device != lam.device
                or tuple(c.shape[1 + batched:]) != tuple(lam.shape)
                or tuple(pack.shape) != ((nb, P) if batched else (P,))):
            raise ValueError(
                "arrow_modes kernel: modes %s %s and pack %s on %s, %s; "
                "expected modes (..., %s) and a pack of %d in %s on %s" % (
                    tuple(c.shape), c.dtype, tuple(pack.shape), c.device,
                    pack.device, tuple(lam.shape), P, lam.dtype,
                    lam.device))
        out = torch.empty_like(c)
        lib = ARROW_BUILD.library()
        with torch.cuda.device(c.device):
            stream = torch.cuda.current_stream(c.device).cuda_stream
            err = lib.ksfd_arrow_modes(
                pack.data_ptr(), P, c.data_ptr(), lam.data_ptr(),
                out.data_ptr(), nl, int(c.shape[batched]) - self.nfields,
                lam.numel(), nb, int(c.dtype == torch.float64), stream)
        if err != 0:
            raise RuntimeError(
                "arrow_modes kernel launch failed: cudaError %d" % err)
        return out

    def solve_modes(self, c, pack):
        """The per-mode solve of the transformed coefficients c: the
        kernel for real modes in the compute dtype on the card; the plain
        chain on the CPU, for the FFT form's complex modes and for a
        single-card bfloat16 pc's bfloat16 coefficients."""
        if (self.arrow is not None and c.is_cuda
                and c.dtype == self.compute_dtype):
            return self.arrow(pack, c)
        return self._arrow_chain(pack, c)

    def apply_packed(self, v, pack):
        """v: (dof, *Sshape); ``pack`` from ``pack``.  Returns the result
        in v's dtype.  Fields past the physical ones (a with-G state's
        G) take the shift-only inverse."""
        c = self._forward(v.to(self.compute_dtype))
        return self._inverse(self.solve_modes(c, pack)).to(v.dtype)

    def apply_linearized(self, v, shift, t, means, rho_diff=None):
        """v: (dof, *Sshape); means: per-field scalars of the STATE
        being linearized (not of v, which is a residual).  Returns the
        result in v's dtype: ``apply_packed`` on a pack made here."""
        return self.apply_packed(v, self.pack(shift, t, means, rho_diff))


class _ArrowKernel(PCKernel):
    """The arrow solve as a ``PCKernel`` (ops/fused_pc.py): a call goes
    through the custom op of ops/fused_stencil.py, so under
    ``torch.func.vmap`` it is one launch for all members, lam unbatched.
    Its operands keep their dtype (float32, or float64 on a float64
    pc)."""

    def prepare(self, *args):
        return [x.contiguous() for x in args]


def make_sharded_apply(precond, ops, mesh):
    """The pc's apply on a mesh, ONE all_reduce per apply: for a
    ``BlockSpectralPreconditioner`` ``apply(v, shift, t, means,
    rho_diff)``, for a ``SpectralPreconditioner`` ``apply(v, shift,
    diff, decay)``, with v this rank's block (its single-card
    ``apply_linearized`` and ``apply`` on the global state); the block
    pc's ``apply.packed(v, pack)`` takes the step's ``precond.pack``.

    Counterpart: ksfd_tpu/solvers/linalg.py:make_sharded_block_apply
    (and, for the spectral pc, the partitioned einsums XLA makes of its
    apply on a sharded state).  The forward products
    (``forward_products``) contract each axis's local rows against this
    rank's rows of that axis's basis (the whole basis on an unsplit
    axis; the x contraction last, so each rank's work is its share);
    the partial mode coefficients are cast to the transform dtype
    (bfloat16 on the wire under ``pc_dtype`` bfloat16) and summed over
    the ranks; the per-mode solve (the block pc's arrow solve, the
    spectral pc's divide) runs replicated in the compute dtype; the
    inverse products (``inverse_products``) give only the local block,
    in the compute dtype from the transform-dtype coefficients and
    bases, as the single-card apply's, with no further collective.

    The FFT form (``use_fft``) gathers the global state, applies the
    single-card float32 FFT pc and keeps the rank's block, as XLA does
    for the reference (ksfd_tpu/solvers/linalg.py:86-89: an FFT along a
    split axis gathers); it has no sum to round, so ``pc_dtype`` does
    not reach it.
    """
    block = isinstance(precond, BlockSpectralPreconditioner)
    if precond.use_fft:
        def on_full(v, fn):
            return mesh.local(fn(mesh.gather(v)), first=1).contiguous()

        if not block:
            return lambda v, *args: on_full(
                v, lambda x: precond.apply(x, *args))

        def apply_packed(v, pack):
            return on_full(v, lambda x: precond.apply_packed(x, pack))
    else:
        td, cd = precond.transform_dtype, precond.compute_dtype
        # each axis's rows of this rank (the whole basis on an unsplit
        # axis)
        fwd = [mesh.axis_rows(getattr(precond, name), d).contiguous()
               for d, name in enumerate(precond._bases)]
        # the inverse's operands: the td-rounded bases in cd (exact)
        inv = [q.to(cd) for q in fwd]

        def transform(v, solve):
            c = forward_products(v.to(td), *fwd, slab=True)
            # THE collective: the partial coefficients, in the transform
            # dtype
            c = all_reduce_sum(c.to(td), mesh)
            return inverse_products(solve(c.to(cd)).to(td).to(cd), *inv,
                                    slab=True).to(v.dtype)

        if not block:
            return lambda v, shift, diff, decay: transform(
                v, lambda c: c / precond._denom(c, shift, diff, decay))

        def apply_packed(v, pack):
            return transform(v, lambda c: precond.solve_modes(c, pack))

    def apply(v, shift, t, means, rho_diff):
        return apply_packed(v, precond.pack(shift, t, means, rho_diff))

    apply.packed = apply_packed
    return apply
