"""Fused float32 block-preconditioner apply (``-pc_pallas 1``).

Counterpart: ksfd_tpu/ops/pallas_pc.py:pack_pc_scalars,
:pallas_pc_available and :make_pallas_block_pc.  The apply
``M^{-1} v = Qx . arrow^{-1}(Qx^T v Qy) . Qy^T`` of the block spectral
preconditioner (solvers/linalg.py BlockSpectralPreconditioner with
``rho_diff`` set, the production configuration) runs as two kernels:

- ``pc_fwd(sc, v32)``: per field ``Qx^T v_f Qy``, then the per-mode
  arrow inverse (a Schur complement on the rho row) as the epilogue,
  from ``lam2d`` and the scalar pack.  Replaces ``fwd_kernel``
  (pallas_pc.py:153, launched at :196).
- ``pc_inv(c)``: per field ``Qx c_f Qy^T``, back to physical space.
  Replaces ``inv_kernel`` (pallas_pc.py:185, launched at :222).

Each is a ``PCKernel``: on a CUDA tensor it launches the hand-written
CUDA kernels of csrc/pc2d.cu (one library for every grid, built by nvcc
at first use through fused_stencil.build_library) or raises; on a CPU
tensor it runs its plain PyTorch version (``torch.matmul`` and the arrow
formula of pallas_pc.py:164-183); any other device raises.  ``launches``
counts calls of the C entry, each of which launches its two products.
The kernels run their products as 3xTF32 on the tensor cores
(``A_lo B_hi + A_hi B_lo + A_hi B_hi``, float32 accumulation): each
basis is split here once into a hi and a lo plane (``split_planes``),
the state-side operand inside the kernel.  That keeps float32-class
results, the numerics of the reference's interpret-mode tests and of
the port's cuBLAS apply with TF32 off; the TPU's bf16 MXU operands are
not copied.  When ``ny % 4 != 0`` the entry first copies its state
operand into a pitched part of the scratch (TMA needs 16-byte row
pitches); ``pitch_copies`` on the owner counts those calls.

**Members.**  The reference's ensemble vmaps the two ``pallas_call``s
(pallas_pc.py:196, :222).  Here a call goes through the custom op of
ops/fused_stencil.py (``call_kernel``), whose vmap rule gives every
operand a leading member axis and runs the wrapper once: on the card
ONE launch of the C entry for all members (``(nb, dof, nx, ny)``
operands, an ``(nb, 3 + 4 nl)`` pack, the members on ``blockIdx.z``,
the bases and lam2d shared), counted once; on the CPU the plain version
member by member.

**Fields.**  Any field count: up to ``MAX_NF`` the arrow inverse is the
epilogue of fwd's second product; above it the second product is plain
and an elementwise pass of the same source solves the arrows (csrc/pc2d.cu
explains why).  One field (no ligand) is ``x = c0 / (shift - rho_diff
lam)``.

The port's gate is wider than the reference's.  Any 2D extent runs (no
128-alignment: the kernels mask ragged tiles).  ``make_fused_block_pc``
refuses a 3D grid, ``pc_dtype`` float64 and a with-G state
(NotImplementedError naming the reason).  The solvers take the
basis-GEMM pc there instead (solvers/solver.py ``_pc_pallas_fallback``),
as the reference's gate (ksfd_tpu/solvers/solver.py:258-282,
ksfd_tpu/ops/pallas_pc.py:66-87) falls back to its einsums there too;
a with-G state's trailing G field then takes the basis-GEMM pc's
shift-only inverse.
"""

import ctypes
from pathlib import Path

import numpy as np
import torch

from ..utils.device import resolve_device
from .fused_stencil import build_library, call_kernel, register_kernel
from .stencil import laplacian_eigendecomp

__all__ = ["pack_pc_scalars", "ligand_table", "fused_pc_available",
           "fused_pc_refusal", "reference_fuses", "make_fused_block_pc", "PCKernel", "PC_BUILD",
           "MAX_NF", "tf32", "split_planes", "scratch_floats"]

CSRC_PC = Path(__file__).resolve().parent.parent / "csrc" / "pc2d.cu"
#: the most fields whose arrow inverse is fwd's epilogue (the consumer
#: threads' register budget); above, a separate arrow pass
MAX_NF = 4
_P, _I = ctypes.c_void_p, ctypes.c_int
_ENTRIES = {
    # (sc, v, bx, by, lam, tmp, out, nf, nx, ny, nb, stream); bx, by:
    # split_planes of Qx^T and Qy^T
    "ksfd_pc_fwd": [_P] * 7 + [_I] * 4 + [_P],
    # (c, bx, by, tmp, out, nf, nx, ny, nb, stream); of Qx and Qy
    "ksfd_pc_inv": [_P] * 5 + [_I] * 4 + [_P],
}
_SRC = "ksfd_tpu/ops/pallas_pc.py"


class _PCBuild:
    """One library of a source that needs no problem header, so a single
    build serves every grid: csrc/pc2d.cu (the fused pc) and
    csrc/arrow.cu (the basis-GEMM pc's arrow solve,
    solvers/linalg.py)."""

    def __init__(self, csrc, entries):
        self.csrc = csrc
        self.entries = entries
        self.build_info = None
        self._lib = None

    def library(self):
        if self._lib is None:
            self._lib, self.build_info = build_library(
                "", self.csrc, entries=self.entries
            )
        return self._lib


PC_BUILD = _PCBuild(CSRC_PC, _ENTRIES)


def tf32(x):
    """float32 numpy values rounded to TF32 (10 mantissa bits, to
    nearest, ties away from zero; cvt.rna.tf32.f32) in float32."""
    u = np.ascontiguousarray(x, dtype=np.float32).view(np.uint32)
    finite = (u & np.uint32(0x7F800000)) != np.uint32(0x7F800000)
    r = (u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)
    return np.where(finite, r, u).astype(np.uint32).view(np.float32)


def split_planes(a):
    """A basis as the kernels' B operand: ``(2, rows, pitch)`` float32,
    plane 0 ``hi = tf32(a)``, plane 1 ``tf32(a - hi)``, each row
    zero-padded to a multiple of 4 floats (a 16-byte TMA pitch)."""
    a = np.asarray(a, dtype=np.float32)
    hi = tf32(a)
    rows, cols = a.shape
    out = np.zeros((2, rows, -(-cols // 4) * 4), dtype=np.float32)
    out[0, :, :cols] = hi
    out[1, :, :cols] = tf32(a - hi)
    return out


def scratch_floats(nf, nx, ny, nb):
    """Floats of an entry's scratch: the S^T planes of the first
    product (nb nf x ny x nxp) and room for the state's pitched copy
    (nb nf x nx x nyp), the extents padded to multiples of 4
    (csrc/pc2d.cu make_plan).  The arrow pass above MAX_NF fields works
    in place on the output and needs none."""
    p4 = lambda n: -(-n // 4) * 4
    return nb * nf * (ny * p4(nx) + nx * p4(ny))


#: the ligand coefficients in the order of the scalar pack
_LIGAND_ORDER = ("s", "gamma", "D")


def ligand_table(ops, dtype, device):
    """The ligands' s, gamma and D in the scalar pack's order
    (``s_1..s_nl, gamma_1..gamma_nl, D_1..D_nl``) as one tensor of
    ``dtype`` on ``device``: each constant cast from its float64 value,
    a t-dependent entry 0 (``pack_pc_scalars`` evaluates it at t).  A pc
    makes it once, when it is built, so that the pack it makes each step
    copies nothing from the host."""
    vals = [0.0 if exprs[name].free_symbols else float(exprs[name])
            for name in _LIGAND_ORDER for exprs in ops.lig_exprs]
    return torch.tensor(vals, dtype=torch.float64).to(dtype=dtype,
                                                      device=device)


def pack_pc_scalars(ops, shift, t, means, rho_diff, ligands=None):
    """The per-step scalar vector of the block pc: ``[shift, rho_diff,
    rho_mean, dG_1..dG_nl, s_1..s_nl, gamma_1..gamma_nl, D_1..D_nl]``
    in the dtype and on the device of ``ligands`` (the pc's
    ``ligand_table``; without it a float32 one, the fused apply's, on
    the device of ``means[0]``, made here).  Each part is cast on its
    own, as pallas_pc.py:90 casts it.  ``rho_diff`` None is the rho
    row's diffusivity at the means, ``rho_mean * dG_0``.

    Nothing else comes from the host: device scalars stay on the device,
    a Python number is filled there, and a t-dependent ligand
    coefficient is evaluated at t (a Python t filled on the device in
    float64)."""
    if ligands is None:
        ligands = ligand_table(ops, torch.float32,
                               torch.as_tensor(means[0]).device)
    dtype, device = ligands.dtype, ligands.device

    def part(x):
        if isinstance(x, torch.Tensor):
            return x.to(device=device, dtype=dtype)
        return torch.full((), float(x), dtype=dtype, device=device)

    nl = ops.nligands
    if rho_diff is None:
        rho_diff = means[0] * ops._dG_fns[0](*means, t)
    head = [shift, rho_diff, means[0]] + [
        ops._dG_fns[1 + l](*means, t) for l in range(nl)]
    if ops._lig_tdep:
        tt = t if isinstance(t, torch.Tensor) else torch.full(
            (), float(t), dtype=torch.float64, device=device)
        entries = [(name, l) for name in _LIGAND_ORDER for l in range(nl)]
        ligands = torch.stack([
            part(ops._lig_coeffs[l][name](tt))
            if ops.lig_exprs[l][name].free_symbols else ligands[k]
            for k, (name, l) in enumerate(entries)])
    return torch.cat([torch.stack([part(x) for x in head]), ligands])


def fused_pc_refusal(grid, ops, pc_dtype="float32"):
    """Why the fused apply cannot run here, or None."""
    if grid.dim != 2:
        return ("pc_pallas on a %dD grid (the fused pc is 2D, as the "
                "reference's is: ROADMAP Queue B item 1, B5)" % grid.dim)
    if ops is not None and grid.dof != ops.nligands + 1:
        return ("pc_pallas on a with-G state (the fused pc takes the "
                "physical fields only, as the reference's does)")
    if pc_dtype in ("float64", "f64"):
        return ("pc_pallas with pc_dtype float64 (the fused apply is "
                "float32: ROADMAP Queue B item 1, B5)")
    return None


def reference_fuses(grid, use_fft=False):
    """Whether the reference's gate (ksfd_tpu/ops/pallas_pc.py:66-87,
    ``pallas_pc_available``) admits the extents of this 2D grid: a
    128-aligned x and y, and its resident fields and y basis within half
    of its 100 MiB scoped-VMEM limit (pallas_stencil.py:77).  Never with
    the FFT pc (``use_fft``): the reference fuses only the basis form
    (ksfd_tpu/solvers/solver.py:258-263, ``not precond.use_fft``)."""
    if grid.dim != 2 or use_fft:
        return False
    nx, ny = (int(n) for n in grid.nps)
    resident = grid.dof * nx * ny * 4 + ny * ny * 4
    return nx % 128 == 0 and ny % 128 == 0 and resident <= 50 * 2 ** 20


def fused_pc_available(grid, ops=None, pc_dtype="float32"):
    """Whether the fused apply runs for this grid and pc dtype: a 2D
    grid of the physical fields only (``dof == nligands + 1``), any
    number of them, float32 transforms.  Any extent: no alignment."""
    return fused_pc_refusal(grid, ops, pc_dtype) is None


class PCKernel:
    """One fused-pc entry: prepare, then the plain body or a CUDA launch.

    ``prepare(*args)`` returns the float32 contiguous operands,
    ``body(*operands)`` is the plain PyTorch version and
    ``launch(*operands)`` the CUDA kernels on the same operands, for one
    member or a leading member axis; the argument ``state_arg`` decides
    the device.  A call dispatches through the custom op of
    ops/fused_stencil.py, so ``torch.func.vmap`` batches it (module
    docstring).  ``launches`` counts calls of the C entry and nothing
    else, ``broadcasts`` the unbatched tensors of vmapped calls.
    """

    def __init__(self, name, body, launch, state_arg, replaces):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        self.broadcasts = 0
        self._state_arg = state_arg
        self._body = body
        self._launch = launch
        self.key = register_kernel(self)

    def prepare(self, *args):
        return [torch.as_tensor(x).to(torch.float32).contiguous()
                for x in args]

    def __call__(self, *args):
        dev = args[self._state_arg].device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(
                "%s kernel: tensors on %s; the kernel runs on cuda and its "
                "plain version on cpu" % (self.name, dev)
            )
        first, *rest = self.prepare(*args)
        return call_kernel(self, first, rest)

    def plain(self, *args):
        """The plain PyTorch version on any device (never counted)."""
        return self.body(*self.prepare(*args))

    def body(self, *operands):
        return self._body(*operands)

    def run(self, first, rest):
        """One member: the CUDA kernels on a CUDA tensor, else the plain
        version (the caller checked the device)."""
        operands = (first,) + tuple(rest)
        if operands[self._state_arg].device.type == "cuda":
            return self.launch(*operands)
        return self.body(*operands)

    def run_batched(self, first, rest):
        """A leading member axis on every operand: one launch on a CUDA
        tensor; on a CPU tensor the plain version member by member."""
        operands = (first,) + tuple(rest)
        if operands[self._state_arg].device.type == "cuda":
            return self.launch(*operands)
        return torch.stack([self.body(*[x[i] for x in operands])
                            for i in range(first.shape[0])])

    def launch(self, *operands):
        """Launch the CUDA kernels on prepared operands."""
        out = self._launch(*operands)
        self.launches += 1
        return out


class _FusedPC:
    """The bases, lam2d and the plain and CUDA bodies of one grid."""

    def __init__(self, grid, ops, device):
        nx, ny = (int(n) for n in grid.nps)
        self.nf = int(grid.dof)
        self.nl = self.nf - 1
        self.Vshape = (self.nf, nx, ny)
        self.Sshape = (nx, ny)
        Qs, lams = [], []
        for d in range(2):
            Q, lam = laplacian_eigendecomp(
                int(grid.nps[d]), float(grid.spacing[d]), grid.stencil_width
            )
            Qs.append(np.asarray(Q, dtype=np.float64))
            lams.append(np.asarray(lam, dtype=np.float64))
        f32 = lambda a: torch.as_tensor(
            np.ascontiguousarray(a), dtype=torch.float32, device=device
        )
        # lam2d: the float64 total, rounded once (pallas_pc.py:130)
        self.lam2d = f32(lams[0][:, None] + lams[1][None, :])
        self.Qx, self.QxT = f32(Qs[0]), f32(Qs[0].T)
        self.Qy, self.QyT = f32(Qs[1]), f32(Qs[1].T)
        # the kernels' B operands: the entries' bases as [hi; lo] planes
        # (fwd: Qx^T, Qy^T; inv: Qx, Qy), split from the float32 bases
        planes = lambda t: f32(split_planes(t.cpu().numpy()))
        self.planes_fwd = (planes(self.QxT), planes(self.QyT))
        self.planes_inv = (planes(self.Qx), planes(self.Qy))
        #: calls whose state operand went through the pitched copy
        self.pitch_copies = 0

    # -- plain versions -------------------------------------------------
    def arrow(self, sc, cs):
        """The arrow inverse per mode, pallas_pc.py:164-183 term by term
        (float32)."""
        nl, lam = self.nl, self.lam2d.to(cs.device)
        shift, rho_diff, rho_mean = sc[0], sc[1], sc[2]
        schur = shift - rho_diff * lam
        num = cs[0]
        backs = []
        for l in range(nl):
            dG_l, s_l = sc[3 + l], sc[3 + nl + l]
            g_l, D_l = sc[3 + 2 * nl + l], sc[3 + 3 * nl + l]
            inv_d = 1.0 / (shift + g_l - D_l * lam)
            b_over_d = (-rho_mean * dG_l) * lam * inv_d
            schur = schur - b_over_d * (-s_l)
            num = num - b_over_d * cs[1 + l]
            backs.append((-s_l, inv_d))
        x_r = num / schur
        outs = [x_r]
        for l in range(nl):
            c_l, inv_d = backs[l]
            outs.append((cs[1 + l] - c_l * x_r) * inv_d)
        return torch.stack(outs)

    def plain_fwd(self, sc, v):
        dev = v.device
        cs = torch.matmul(torch.matmul(self.QxT.to(dev), v), self.Qy.to(dev))
        return self.arrow(sc, cs)

    def plain_inv(self, c):
        dev = c.device
        return torch.matmul(torch.matmul(self.Qx.to(dev), c),
                            self.QyT.to(dev))

    # -- CUDA launches --------------------------------------------------
    def _check(self, name, sc, fields):
        """Check the operands of one member, ``(dof, nx, ny)`` with a
        ``(k,)`` pack, or of nb members, ``(nb, dof, nx, ny)`` with an
        ``(nb, k)`` pack; returns nb."""
        for x in ((sc,) if sc is not None else ()) + (fields,):
            if x.device.type != "cuda" or x.dtype != torch.float32:
                raise ValueError("%s kernel: operands must be float32 on "
                                 "the card" % name)
        batched = fields.dim() == len(self.Vshape) + 1
        nb = int(fields.shape[0]) if batched else 1
        lead = (nb,) if batched else ()
        if tuple(fields.shape) != lead + self.Vshape \
                or not fields.is_contiguous():
            raise ValueError("%s kernel: operand shape %s, expected "
                             "contiguous %s" % (name, tuple(fields.shape),
                                                lead + self.Vshape))
        if self.Qx.device != fields.device:
            raise ValueError("%s kernel: bases on %s, operand on %s" % (
                name, self.Qx.device, fields.device))
        k = 3 + 4 * self.nl
        if sc is not None and (sc.device != fields.device
                               or tuple(sc.shape) != lead + (k,)
                               or not sc.is_contiguous()):
            raise ValueError("%s kernel: scalar pack of shape %s on %s, "
                             "expected %s on %s" % (
                                 name, tuple(sc.shape), sc.device,
                                 lead + (k,), fields.device))
        return nb

    def _run(self, name, fields, nb, ptrs):
        lib = PC_BUILD.library()
        tmp = torch.empty(scratch_floats(self.nf, *self.Sshape, nb),
                          dtype=torch.float32, device=fields.device)
        out = torch.empty_like(fields)
        if self.Sshape[1] % 4 or fields.data_ptr() % 16:
            self.pitch_copies += 1
        with torch.cuda.device(fields.device):
            stream = torch.cuda.current_stream(fields.device).cuda_stream
            err = getattr(lib, "ksfd_" + name)(
                *ptrs, tmp.data_ptr(), out.data_ptr(), self.nf,
                *self.Sshape, nb, stream,
            )
        if err != 0:
            raise RuntimeError(
                "%s kernel launch failed: cudaError %d" % (name, err)
            )
        return out

    def launch_fwd(self, sc, v):
        nb = self._check("pc_fwd", sc, v)
        bx, by = self.planes_fwd
        return self._run("pc_fwd", v, nb, [
            sc.data_ptr(), v.data_ptr(), bx.data_ptr(), by.data_ptr(),
            self.lam2d.data_ptr(),
        ])

    def launch_inv(self, c):
        nb = self._check("pc_inv", None, c)
        bx, by = self.planes_inv
        return self._run("pc_inv", c, nb, [
            c.data_ptr(), bx.data_ptr(), by.data_ptr(),
        ])


def make_fused_block_pc(grid, ops, device=None):
    """Build the fused apply ``apply(sc, v32) -> M^{-1} v32`` (float32).

    Counterpart: ksfd_tpu/ops/pallas_pc.py:make_pallas_block_pc.  ``sc``
    from ``pack_pc_scalars`` (given ``apply.ligands``, the pc's
    ``ligand_table``); v32 is ``(dof, nx, ny)``.  The same
    arithmetic as ``apply_linearized`` with ``rho_diff`` set, up to the
    association of the products.  ``apply.fwd(sc, v32)`` and
    ``apply.inv(c)`` are the two halves (PCKernels, also in
    ``apply.kernels``); the bases live on ``device``, ops' device unless
    given.
    """
    why = fused_pc_refusal(grid, ops)
    if why is not None:
        raise NotImplementedError("not ported yet (see ROADMAP): " + why)
    device = resolve_device(device if device is not None else ops.device)
    owner = _FusedPC(grid, ops, device)
    fwd = PCKernel("pc_fwd", owner.plain_fwd, owner.launch_fwd, 1,
                   _SRC + ":153")
    inv = PCKernel("pc_inv", owner.plain_inv, owner.launch_inv, 0,
                   _SRC + ":185")

    def apply(sc, v32):
        return inv(fwd(sc, v32))

    apply.fwd = fwd
    apply.inv = inv
    apply.kernels = {"pc_fwd": fwd, "pc_inv": inv}
    apply.owner = owner
    apply.ligands = ligand_table(ops, torch.float32, owner.lam2d.device)
    return apply
