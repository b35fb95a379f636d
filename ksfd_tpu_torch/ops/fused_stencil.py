"""Fused float32 stencil kernels: rhs, jvp, resid and delta.

Counterpart: ksfd_tpu/ops/pallas_stencil.py:make_pallas_kernels (2D;
3D grids go to ops/fused_stencil3d.py, as the reference dispatches to
make_pallas_kernels_3d at pallas_stencil.py:474).
``make_fused_kernels(ops)`` returns a namespace with the same entries,
call signatures and scalar packing as the Pallas build's
``rhs``/``jvp``/``resid``/``delta`` (pallas_stencil.py:851-911):

- ``rhs(u, t)``: the full float32 RHS of the float32 fast mode, u
  groomed in the kernel, every differenced quantity centred on float64
  means (``sc = [t, mean_0..mean_{dof-1}, G(means),
  react_1..react_{dof-1}]``, the means over the groomed view and
  ``react_l = s_l*mean_0 - gamma_l*mean_l``, all computed in float64
  and cast once).  Active sources are added after the launch, in f32,
  as ``rhs_fn`` adds them.  Replaces ``rhs_kernel``
  (pallas_stencil.py:584).
- ``jvp(u, v, t)``: the exact J-action J(u)v of the product-rule RHS,
  u groomed in the kernel and the tangent zeroed where the clamp is
  active.  Replaces ``jvp_kernel`` (pallas_stencil.py:648).
- ``resid(u, v, b, t, shift)``: the fused Richardson residual
  ``b - (shift*v - J(u)v)``.  Replaces ``resid_kernel`` (:655).
- ``delta(u0, d, u1, t)``: the increment ``rhs(u1) - rhs(u0)`` of the
  source-free RHS through the cancellation-free G_delta of
  ops/delta.py, centred on float64 means.  Replaces ``delta_kernel``
  (:674).

The 2D namespace also holds ``coeff_resid(C, v, b, t, shift)``, B11:
the resid kernel fed from precomputed float32 coefficient fields ``C =
[rho_g, G, dG'_0..dG'_{dof-1}, maskpack]`` (``(dof+3, nx, ny)``, built
by ksfd_tpu_torch/tools/probe_coeff_kernel.py ``prepare``), with no
pointwise transcendental.  Replaces the probe's ``resid_kernel``
(tools/probe_coeff_kernel.py:114); it lies on no solver path.

Each entry is a ``FusedKernel``: on a CUDA tensor it launches the
hand-written CUDA kernel of csrc/stencil2d.cu (built at first use, see
``build_library``) or raises; on a CPU tensor it runs its plain
PyTorch version (``.plain``, ``torch.roll`` stencils over the
torchify'd G/dG/G_delta, summed over the axes in the order x, y(, z)
of the Pallas bodies); any other device raises.  ``launches`` counts
kernel launches and nothing else.  The kernels are memory-bound: see
the note at the top of csrc/stencil2d.cu.

**Member batching** (the counterpart of pallas_stencil.py
``member_batching_rules``, :87-123, used in 3D at
pallas_stencil3d.py:578-582).  A call goes through a
``torch.library.custom_op`` (``ksfd_tpu_torch::kernel<n>``, one per
operand count, shared with ops/fused_pc.py) whose ``register_vmap`` rule
stands in for ``jax.custom_batching``: under ``torch.func.vmap`` the
rule receives the member-leading operands and scalar packs, broadcasts
the unbatched ones (as pallas_stencil.py:113-118 does) and makes ONE
batched launch (``(nb, dof, *S)`` operands, an ``(nb, k)`` pack; the
members on ``blockIdx.z`` in 2D, the slowest part of a 1D block index
in 3D), counted once.  So ``EnsembleSolver`` vmaps the
unchanged ``make_step_fn``/``make_multistep_fn``.  On CPU tensors the
rule runs the plain body member by member.

**Halo-slab builds** (B9, the counterpart of ``make_pallas_kernels(
mesh=)``: pad_x :718-735, shardwrap :737-755, padded_src :539).  With a
``mesh`` (parallel/mesh.py SlabMesh) the four step entries are
``SlabKernel``s on this rank's local x-slab: each stencil operand's
``sw`` halo rows come from the ring neighbours in one exchange, the f64
centring means are global sums over the ranks over the global point
count, and the CUDA entries ``ksfd_<name>_halo`` read the halo rows
where they lie (no padded copy).  Their plain versions pad each operand
by ``torch.cat`` and crop.  A halo-slab build has no member axis, and
a mesh that splits y or z runs none (``mesh_kernel_refusal``, the
reference's ``pallas_mesh_ok``): the step is unfused there.
"""

import ctypes
import hashlib
import itertools
import os
import shutil
import subprocess
import threading
import time
import weakref
from pathlib import Path
from types import SimpleNamespace

import torch

from ..parallel.mesh import (
    SlabMesh,
    all_reduce_sum,
    exchange_halos,
)
from .codegen import pointwise_header
from .stencil import deriv_coeffs

__all__ = ["make_fused_kernels", "kernels_available", "kernel_refusal",
           "mesh_kernel_refusal", "FusedKernel", "build_library"]

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc" / "stencil2d.cu"
BUILD_DIR = _PKG / "_build"
# -fmad=false: no multiply-add contraction, so each product and sum
# rounds once, as in the plain versions' separate PyTorch operations.
# The rhs kernels need it: on a near-uniform state one ulp of G moves
# the centred rho*lap(G - G_mean) row by its whole size.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
#: operands of each stencil entry (besides the scalar pack and out)
_OPERANDS = {
    "rhs": 1,          # (sc, u) -> out
    "jvp": 2,          # (sc, u, v) -> out
    "resid": 3,        # (sc, u, v, b) -> out
    "delta": 3,        # (sc, u0, d, u1) -> out
    "coeff_resid": 3,  # (sc, C, v, b) -> out, 2D only (B11)
}
#: the solver path's four entries, in both dimensions
STEP_ENTRIES = ("rhs", "jvp", "resid", "delta")
#: the halo-slab entries (B9): how many leading operands the stencil
#: reads (each passed with its lo and hi halo rows), and how many it reads
#: at the tile's own points only
HALO_OPERANDS = dict(rhs=(1, 0), jvp=(2, 0), resid=(2, 1), delta=(3, 0))


NVCC_DEFAULT = "/usr/local/cuda/bin/nvcc"


def _nvcc():
    path = shutil.which("nvcc") or NVCC_DEFAULT
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the CUDA stencil kernels are built with the "
            "CUDA toolkit on the machine that has the card"
        )
    return path


def entry_names(ndim):
    """The stencil entries of a dimension's kernel source: the four of
    the step, and in 2D also B11's ``coeff_resid`` (3D has none, as the
    reference has none)."""
    return STEP_ENTRIES + (("coeff_resid",) if ndim == 2 else ())


def stencil_entries(ndim):
    """ctypes argument types of the stencil entries ``ksfd_<name>`` of
    a dimension: the scalar pack, operand and output pointers, the
    ``ndim`` grid extents, the member count ``nb``, then the stream; and
    of the halo-slab entries ``ksfd_<name>_halo`` (B9): the scalar pack,
    each stencil operand with its lo and hi rows, the own-point
    operands, the output, the slab's ``ndim`` extents and the stream."""
    out = {
        "ksfd_" + name: [ctypes.c_void_p] * (_OPERANDS[name] + 2)
        + [ctypes.c_int] * (ndim + 1) + [ctypes.c_void_p]
        for name in entry_names(ndim)
    }
    for name, (n_st, n_own) in HALO_OPERANDS.items():
        out["ksfd_%s_halo" % name] = (
            [ctypes.c_void_p] * (3 * n_st + n_own + 2)
            + [ctypes.c_int] * ndim + [ctypes.c_void_p])
    return out


def build_library(header, csrc=CSRC, ndim=2, entries=None):
    """Compile a kernel source (csrc/stencil2d.cu by default) with a
    generated pointwise header and load it.  Returns (ctypes.CDLL,
    info dict).

    The build lands in ``ksfd_tpu_torch/_build/<content hash>/``, keyed
    on the kernel source, the header and the flags, so a second call
    with the same problem reuses it and the 2D and 3D libraries are
    separate builds.  ``info`` holds the library path, the nvcc seconds
    (0.0 when reused) and the ptxas report.  ``entries`` maps each C
    entry to its ctypes argument types (each returns an int error
    code); by default the stencil entries of ``stencil_entries(ndim)``.
    A source that needs no header (csrc/pc2d.cu) passes ``header=""``.
    """
    csrc = Path(csrc)
    src = csrc.read_text()
    key = hashlib.sha256(
        "\0".join([src, header, " ".join(NVCC_FLAGS)]).encode()
    ).hexdigest()[:16]
    out_dir = BUILD_DIR / key
    lib = out_dir / ("libksfd_%s.so" % csrc.stem)
    log = out_dir / "nvcc.log"
    seconds = 0.0
    if not lib.exists():
        nvcc = _nvcc()
        out_dir.mkdir(parents=True, exist_ok=True)
        (out_dir / "ksfd_pointwise.cuh").write_text(header)
        # unique per process and thread: two threads may build one key
        tmp = out_dir / ("lib.%d.%d.so" % (os.getpid(),
                                            threading.get_ident()))
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-I", str(out_dir), "-o", str(tmp),
             str(csrc)],
            capture_output=True, text=True,
        )
        seconds = time.perf_counter() - t0
        log.write_text(proc.stdout + proc.stderr)
        if proc.returncode != 0:
            raise RuntimeError(
                "nvcc failed (rc=%d):\n%s" % (proc.returncode, proc.stderr)
            )
        os.replace(tmp, lib)
    cdll = ctypes.CDLL(str(lib))
    if entries is None:
        entries = stencil_entries(ndim)
    for name, argtypes in entries.items():
        fn = getattr(cdll, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    info = dict(
        path=str(lib), nvcc_seconds=seconds,
        ptxas=log.read_text() if log.exists() else "",
    )
    return cdll, info


#: live kernel wrappers by key (FusedKernel here, PCKernel in
#: ops/fused_pc.py): the custom ops carry the key, not the object.  A
#: wrapper has ``run(sc, operands)`` for one member,
#: ``run_batched(sc, operands)`` for a leading member axis on every
#: tensor, and ``broadcasts``, the count of unbatched tensors the vmap
#: rule copied to every member.
_KERNELS = weakref.WeakValueDictionary()
_NEXT_KEY = itertools.count()


def register_kernel(kernel):
    """Enter a kernel wrapper in the registry; returns its key."""
    key = next(_NEXT_KEY)
    _KERNELS[key] = kernel
    return key


def _op_impl(key, sc, *operands):
    """The custom op's body outside vmap: one member."""
    return _KERNELS[key].run(sc, operands)


def _op_vmap(info, in_dims, key, sc, *operands):
    """The vmap rule (pallas_stencil.py member_batching_rules): every
    operand and the scalar pack get a leading member axis, the
    unbatched ones broadcast to it (and counted), and the batched entry
    runs once."""
    n = info.batch_size
    kernel = _KERNELS[key]
    kernel.broadcasts += sum(d is None for d in in_dims[1:])

    def lead(x, dim):
        x = x.movedim(dim, 0) if dim is not None else x.expand(
            (n,) + tuple(x.shape))
        return x.contiguous()

    return kernel.run_batched(
        lead(sc, in_dims[1]),
        [lead(x, d) for x, d in zip(operands, in_dims[2:])]), 0


def _make_op(n_in):
    args = "".join(", Tensor x%d" % i for i in range(n_in))
    op = torch.library.custom_op(
        "ksfd_tpu_torch::kernel%d" % n_in, _op_impl, mutates_args=(),
        schema="(int key, Tensor sc%s) -> Tensor" % args)
    op.register_vmap(_op_vmap)
    return op


#: the custom ops by operand count besides the first tensor (0: the
#: fused pc's pc_inv, 1..3: the stencil kernels and pc_fwd)
_KERNEL_OPS = {n: _make_op(n) for n in range(4)}


def call_kernel(kernel, sc, operands):
    """Call a registered wrapper through the custom op of its operand
    count, so that ``torch.func.vmap`` batches it."""
    return _KERNEL_OPS[len(operands)](kernel.key, sc, *operands)


class FusedKernel:
    """One kernel entry: prepare, then the plain body or a CUDA launch.

    ``prepare(*args)`` turns the caller's arguments into the f32 scalar
    pack and f32 contiguous operands (the packing of the Pallas
    wrappers); ``body(sc, operands)`` is the plain PyTorch version of
    the kernel and ``launch(sc, operands)`` the CUDA kernel on the same
    operands, for one member or a leading member axis.  A call
    dispatches through the custom op of its operand count, so
    ``torch.func.vmap`` batches it (see the module docstring).
    ``launches`` counts CUDA launches, ``broadcasts`` the unbatched
    tensors of vmapped calls.  ``planes`` gives each operand's leading
    extent (the state's ``dof`` unless given).
    """

    def __init__(self, name, owner, prepare, body, replaces, planes=None):
        self.name = name
        self.replaces = replaces
        self.launches = 0
        self.broadcasts = 0
        self._owner = owner
        self.prepare = prepare
        self._body = body
        self.planes = tuple(planes or (owner.dof,) * _OPERANDS[name])
        self.key = register_kernel(self)

    def __call__(self, *args):
        dev = args[0].device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(
                "%s kernel: tensors on %s; the kernel runs on cuda and its "
                "plain version on cpu" % (self.name, dev)
            )
        sc, operands = self.prepare(*args)
        return call_kernel(self, sc, operands)

    def plain(self, *args):
        """The plain PyTorch version on any device (never counted)."""
        return self.body(*self.prepare(*args))

    def body(self, sc, operands):
        return self._body(sc, *operands)

    def run(self, sc, operands):
        """One member: the CUDA kernel on a CUDA tensor, else the plain
        version (the caller checked the device)."""
        if sc.device.type == "cuda":
            return self.launch(sc, operands)
        return self.body(sc, operands)

    def run_batched(self, sc, operands):
        """A leading member axis: one batched launch on a CUDA tensor;
        on a CPU tensor the plain version member by member."""
        if sc.device.type == "cuda":
            return self.launch(sc, operands)
        return torch.stack([self.body(sc[i], [x[i] for x in operands])
                            for i in range(sc.shape[0])])

    def launch(self, sc, operands):
        """Launch the CUDA kernel on prepared operands: ``(planes, *S)``
        each with a ``(k,)`` pack, or ``(nb, planes, *S)`` with an
        ``(nb, k)`` pack, one launch for all nb members."""
        S = self._owner.Sshape
        batched = operands[0].dim() == len(S) + 2
        nb = int(operands[0].shape[0]) if batched else 1
        lead = (nb,) if batched else ()
        for x in (sc,) + tuple(operands):
            if x.device != sc.device or x.dtype != torch.float32:
                raise ValueError("%s kernel: operands must be f32 on one "
                                 "device" % self.name)
        for x, p in zip(operands, self.planes):
            if tuple(x.shape) != lead + (p,) + S or not x.is_contiguous():
                raise ValueError("%s kernel: operand shape %s, expected "
                                 "contiguous %s" % (self.name, tuple(x.shape),
                                                    lead + (p,) + S))
        if sc.dim() != 1 + batched or (batched and sc.shape[0] != nb) \
                or not sc.is_contiguous():
            raise ValueError("%s kernel: scalar pack shape %s for %d "
                             "member(s)" % (self.name, tuple(sc.shape), nb))
        lib = self._owner.library()
        out = torch.empty(lead + (self._owner.dof,) + S, dtype=torch.float32,
                          device=sc.device)
        with torch.cuda.device(sc.device):
            stream = torch.cuda.current_stream(sc.device).cuda_stream
            err = getattr(lib, "ksfd_" + self.name)(
                sc.data_ptr(), *[x.data_ptr() for x in operands],
                out.data_ptr(), *S, nb, stream,
            )
        if err != 0:
            raise RuntimeError(
                "%s kernel launch failed: cudaError %d" % (self.name, err)
            )
        self.launches += 1
        return out


class SlabKernel(FusedKernel):
    """B9: one entry's halo-slab build on a rank's local x-slab.
    Counterpart: ksfd_tpu/ops/pallas_stencil.py:shardwrap around the
    entry's ``pallas_call`` fed by ``pad_x`` (3D:
    pallas_stencil3d.py:shardwrap).

    ``prepare(*args)`` takes the entry's usual arguments on local slabs
    and returns the f32 pack (its means global over the mesh) and the
    operands, each stencil operand followed by its ``lo`` and ``hi``
    halo rows (one exchange for all of them, parallel/mesh.py
    ``exchange_halos``), then the own-point operands.  On a CUDA tensor
    ``run`` launches ``ksfd_<name>_halo`` (csrc/stencil2d.cu,
    csrc/stencil3d.cu), which reads the halo rows where they lie; on a
    CPU tensor it runs the plain version: the unsharded plain body on
    each operand padded by ``torch.cat`` of lo, the slab and hi, cropped
    to the slab.  No member axis (a batched build is never sharded,
    pallas_stencil.py:526), so a call does not go through the vmap op,
    and a call under ``torch.func.vmap`` raises on either device before
    its halo exchange (an ensemble on a mesh takes the unfused step,
    solvers/ensemble.py, and never reaches it).
    """

    def __init__(self, name, owner, prepare, body, replaces, mesh):
        super().__init__(name, owner, prepare, body, replaces)
        self.mesh = mesh
        self.n_st, self.n_own = HALO_OPERANDS[name]

    def __call__(self, *args):
        if torch._C._functorch.is_batchedtensor(args[0]):
            self.run_batched(None, None)
        dev = args[0].device
        if dev.type not in ("cuda", "cpu"):
            raise ValueError(
                "%s kernel: tensors on %s; the kernel runs on cuda and its "
                "plain version on cpu" % (self.name, dev))
        return self.run(*self.prepare(*args))

    def run_batched(self, sc, operands):
        raise NotImplementedError(
            "a halo-slab build has no member axis (pallas_stencil.py:526, "
            "as the reference's): EnsembleSolver(mesh=) takes the unfused "
            "step")

    def body(self, sc, operands):
        sw = self._owner.ops.sw
        padded = []
        for i in range(self.n_st):
            x, lo, hi = operands[3 * i:3 * i + 3]
            padded.append(torch.cat([lo, x, hi], dim=1))
        for x in operands[3 * self.n_st:]:
            # read at the tile's own points only: the pad is cropped
            z = torch.zeros_like(x[:, :sw])
            padded.append(torch.cat([z, x, z], dim=1))
        return self._body(sc, *padded)[:, sw:-sw].contiguous()

    def launch(self, sc, operands):
        S = self.mesh.local_shape
        dof, sw = self._owner.dof, self._owner.ops.sw
        halo = (dof, sw) + S[1:]
        shapes = [s for _ in range(self.n_st)
                  for s in ((dof,) + S, halo, halo)]
        shapes += [(dof,) + S] * self.n_own
        if len(operands) != len(shapes):
            raise ValueError("%s halo kernel: %d operands, expected %d"
                             % (self.name, len(operands), len(shapes)))
        for x, shape in zip((sc,) + tuple(operands), [None] + shapes):
            if x.device != sc.device or x.dtype != torch.float32:
                raise ValueError("%s halo kernel: operands must be f32 on "
                                 "one device" % self.name)
            if shape is not None and (tuple(x.shape) != shape
                                      or not x.is_contiguous()):
                raise ValueError("%s halo kernel: operand shape %s, expected "
                                 "contiguous %s" % (self.name,
                                                    tuple(x.shape), shape))
        lib = self._owner.library()
        out = torch.empty((dof,) + S, dtype=torch.float32, device=sc.device)
        with torch.cuda.device(sc.device):
            stream = torch.cuda.current_stream(sc.device).cuda_stream
            err = getattr(lib, "ksfd_%s_halo" % self.name)(
                sc.data_ptr(), *[x.data_ptr() for x in operands],
                out.data_ptr(), *S, stream)
        if err != 0:
            raise RuntimeError("%s halo kernel launch failed: cudaError %d"
                               % (self.name, err))
        self.launches += 1
        return out


class _FusedBuild:
    """Owner of one problem's kernels: the generated header, the lazily
    built library (from ``csrc``) and the plain bodies, which hold for
    any dimension: every stencil sums over the grid's axes in order."""

    def __init__(self, ops, csrc=CSRC):
        grid = ops.grid
        why = kernel_refusal(grid, ops)
        if why is not None:
            raise ValueError("no fused kernels for %s (kernels_available)"
                             % why)
        self.ops = ops
        self.csrc = Path(csrc)
        self.dim = grid.dim
        self.Sshape = tuple(grid.Sshape)
        self.Vshape = tuple(grid.Vshape)
        self.dof = ops.nligands + 1
        self.header = pointwise_header(ops)
        self.build_info = None
        self._lib = None
        # per axis: first- and second-derivative coefficients
        self._c1, self._c2 = (
            [[float(c) for c in deriv_coeffs(order, ops.sw, h)]
             for h in ops.spacing]
            for order in (1, 2)
        )

    def library(self):
        if self._lib is None:
            self._lib, self.build_info = build_library(
                self.header, self.csrc, self.dim
            )
        return self._lib

    # -- plain stencils (the order of the Pallas _d sums) ---------------
    def _d(self, a, cs, axis):
        sw = (len(cs) - 1) // 2
        acc = None
        for j in range(-sw, sw + 1):
            c = cs[j + sw]
            if c == 0.0:
                continue
            term = c * torch.roll(a, -j, dims=axis)
            acc = term if acc is None else acc + term
        return acc

    def lap(self, a):
        acc = self._d(a, self._c2[0], 0)
        for axis in range(1, self.dim):
            acc = acc + self._d(a, self._c2[axis], axis)
        return acc

    def graddot(self, a, b):
        c1 = self._c1
        acc = self._d(a, c1[0], 0) * self._d(b, c1[0], 0)
        for axis in range(1, self.dim):
            acc = acc + self._d(a, c1[axis], axis) * self._d(b, c1[axis], axis)
        return acc

    # -- plain bodies ----------------------------------------------------
    def _groom(self, u):
        """The where-form clamp: NaN compares False, so NaN -> min."""
        ops = self.ops
        return [torch.where(u[0] >= ops.rhomin, u[0], ops.rhomin)] + [
            torch.where(u[k] >= ops.Umin, u[k], ops.Umin)
            for k in range(1, self.dof)
        ]

    def plain_rhs(self, sc, u):
        """Counterpart of pallas_stencil.py rhs_kernel (:584): the RHS
        with rho, G and each U centred on the scalar pack's means (the
        centring removes the f32 cancellation of O(1e4) fields with
        O(1e-4) derivatives); rho*lap(Gc) takes the uncentred rho."""
        ops, dof, t = self.ops, self.dof, sc[0]
        fields = self._groom(u)
        rho = fields[0]
        Gc = ops._G_fn(*fields, t) - sc[1 + dof]
        rho_c = rho - sc[1]
        rows = [self.graddot(rho_c, Gc) + rho * self.lap(Gc)]
        for l, (gamma, s, D) in enumerate(self.coeffs(t)):
            Uc = fields[1 + l] - sc[2 + l]
            rows.append(
                -gamma * Uc + s * rho_c + sc[2 + dof + l] + D * self.lap(Uc)
            )
        return torch.stack(rows)

    def coeffs(self, t):
        """Each ligand's (gamma, s, D) at t: Python floats where
        constant, else tensors of t's dtype (the kernels' float32 t)."""
        return [(c["gamma"](t), c["s"](t), c["D"](t))
                for c in self.ops._lig_coeffs]

    def jvp_rows(self, t, u, v):
        """Counterpart of pallas_stencil.py _jvp_rows (:613)."""
        ops = self.ops
        rmin, umin = ops.rhomin, ops.Umin
        fields = self._groom(u)
        # clamp derivative: tangent zeroed where the clamp is active
        vm = [torch.where(u[0] > rmin, v[0], 0.0)] + [
            torch.where(u[k] > umin, v[k], 0.0) for k in range(1, self.dof)
        ]
        G = ops._G_fn(*fields, t)
        dGs = [fn(*fields, t) for fn in ops._dG_fns]
        dG = dGs[0] * vm[0]
        for k in range(1, self.dof):
            dG = dG + dGs[k] * vm[k]
        return self._rows(t, fields[0], G, dG, vm)

    def _rows(self, t, rho, G, dG, vm):
        """The J-action rows at t from the groomed rho, G, dG.v and the
        masked tangents."""
        rows = [
            self.graddot(vm[0], G)
            + self.graddot(rho, dG)
            + vm[0] * self.lap(G)
            + rho * self.lap(dG)
        ]
        for l, (gamma, s, D) in enumerate(self.coeffs(t)):
            rows.append(
                -gamma * vm[1 + l] + s * vm[0] + D * self.lap(vm[1 + l])
            )
        return rows

    def plain_jvp(self, sc, u, v):
        return torch.stack(self.jvp_rows(sc[0], u, v))

    def plain_resid(self, sc, u, v, b):
        shift = sc[1]
        rows = self.jvp_rows(sc[0], u, v)
        return torch.stack(
            [b[f] - shift * v[f] + rows[f] for f in range(self.dof)]
        )

    def plain_coeff_resid(self, sc, C, v, b):
        """Counterpart of tools/probe_coeff_kernel.py resid_kernel
        (:114): plain_resid from the coefficient fields ``C = [rho_g,
        G, dG'_0..dG'_{dof-1}, maskpack]``.  The dG'_i come masked, so
        dG takes the raw tangent; the rows' tangents are masked by
        maskpack's bits.  Summed in the order of plain_resid."""
        dof, shift = self.dof, sc[1]
        mask = C[2 + dof].to(torch.int32)
        vm = [torch.where((mask >> k) & 1 > 0, v[k], 0.0)
              for k in range(dof)]
        dG = C[2] * v[0]
        for k in range(1, dof):
            dG = dG + C[2 + k] * v[k]
        rows = self._rows(sc[0], C[0], C[1], dG, vm)
        return torch.stack(
            [b[f] - shift * v[f] + rows[f] for f in range(dof)]
        )

    def plain_delta(self, sc, u0, d, u1):
        """Counterpart of pallas_stencil.py delta_kernel (:674)."""
        ops = self.ops
        t, rho_mean, G_mean = sc[0], sc[1], sc[2]
        f0 = [u0[k] for k in range(self.dof)]
        dd = [d[k] for k in range(self.dof)]
        s = [u1[k] for k in range(self.dof)]
        G0c = ops._G_fn(*f0, t) - G_mean
        dG = ops._G_delta_fn(*f0, *dd, *s, t)
        Gs = G0c + dG
        rho0c = f0[0] - rho_mean
        drho = dd[0]
        rows = [
            self.graddot(drho, Gs)
            + self.graddot(rho0c, dG)
            + drho * self.lap(Gs)
            + f0[0] * self.lap(dG)
        ]
        for l, (gamma, s, D) in enumerate(self.coeffs(t)):
            rows.append(
                -gamma * dd[1 + l] + s * drho + D * self.lap(dd[1 + l])
            )
        return torch.stack(rows)

    # -- scalar packs (pallas_stencil.py:851-911) -------------------------
    def _groomed(self, u, i):
        lo = self.ops.rhomin if i == 0 else self.ops.Umin
        f = u[i]
        return torch.where(f >= lo, f, lo)

    def _means_groomed(self, u, mesh=None):
        """Float64 means over the groomed view of each field of an f32
        or f64 state (a NaN entry must not poison the centring scalars).
        One field at a time: an f32 state is never copied whole to
        f64.  On a mesh (u a local slab) each is the global sum over the
        ranks, one all_reduce for all fields, over the global point
        count (pallas_stencil.py _mean_groomed :846 on sharded state)."""
        if mesh is None:
            return [torch.mean(self._groomed(u, i), dtype=torch.float64)
                    for i in range(self.dof)]
        sums = torch.stack([torch.sum(self._groomed(u, i),
                                      dtype=torch.float64)
                            for i in range(self.dof)])
        return list(all_reduce_sum(sums, mesh) / mesh.n_points)

    @staticmethod
    def _f32(*xs):
        return [x.to(torch.float32).contiguous() for x in xs]

    def prep_rhs(self, u, t, mesh=None):
        ops, dev = self.ops, u.device
        means = self._means_groomed(u, mesh)
        t64 = torch.as_tensor(t, dtype=torch.float64, device=dev)
        G_m = torch.as_tensor(ops._G_fn(*means, t64), dtype=torch.float64,
                              device=dev)
        reacts = [
            s * means[0] - gamma * means[1 + l]
            for l, (gamma, s, _) in enumerate(self.coeffs(t64))
        ]
        sc = torch.stack([t64] + means + [G_m] + reacts).to(torch.float32)
        return sc, self._f32(u)

    def prep_jvp(self, u, v, t, mesh=None):
        sc = torch.as_tensor(t, dtype=torch.float32, device=u.device)
        return sc.reshape(1), self._f32(u, v)

    def prep_resid(self, u, v, b, t, shift, mesh=None):
        dev = u.device
        sc = torch.stack([
            torch.as_tensor(t, dtype=torch.float32, device=dev),
            torch.as_tensor(shift, dtype=torch.float32, device=dev),
        ])
        return sc, self._f32(u, v, b)

    def prep_coeff_resid(self, C, v, b, t, shift):
        """The f32 pack ``[t, shift]`` on the device, as prep_resid."""
        return self.prep_resid(C, v, b, t, shift)

    def prep_delta(self, u0, d, u1, t, mesh=None):
        dev = u0.device
        means = self._means_groomed(u0, mesh)
        t64 = torch.as_tensor(t, dtype=torch.float64, device=dev)
        G_m = torch.as_tensor(
            self.ops._G_fn(*means, t64), dtype=torch.float64, device=dev
        )
        sc = torch.stack([t64, means[0], G_m]).to(torch.float32)
        return sc, self._f32(u0, d, u1)


def _halo_prepare(build, name, mesh):
    """A SlabKernel's prepare: the entry's pack and f32 operands (means
    global over the mesh), each stencil operand followed by its halo
    rows from one exchange."""
    prep = getattr(build, "prep_" + name)
    n_st = HALO_OPERANDS[name][0]

    def prepare(*args):
        sc, operands = prep(*args, mesh=mesh)
        halos = exchange_halos(operands[:n_st], build.ops.sw, mesh)
        out = []
        for x, (lo, hi) in zip(operands[:n_st], halos):
            out += [x, lo, hi]
        return sc, out + list(operands[n_st:])

    return prepare


def kernel_namespace(build, replaces, mesh=None, sharded=None):
    """The ``rhs``/``jvp``/``resid``/``delta`` namespace over one
    _FusedBuild (and ``coeff_resid`` where ``replaces`` names it);
    ``replaces`` maps each name to the TPU kernel's file:line.  ``rhs``
    is the kernel plus the active sources, added after the launch as
    pallas_stencil.py:866-870 adds them; the other entries are the
    kernels themselves.  ``kernels`` holds the four of the step.

    With a ``mesh`` (parallel/mesh.py SlabMesh) the four entries are the
    halo-slab builds (B9, SlabKernel) on this rank's slab, ``sharded``
    naming what each replaces; ``kind`` records which build runs."""
    b = build
    if mesh is None:
        made = {
            name: FusedKernel(
                name, b, getattr(b, "prep_" + name),
                getattr(b, "plain_" + name), replaces[name],
                planes=(b.dof + 3, b.dof, b.dof) if name == "coeff_resid"
                else None)
            for name in replaces
        }
        kind = "unsharded"
    else:
        made = {
            name: SlabKernel(name, b, _halo_prepare(b, name, mesh),
                             getattr(b, "plain_" + name), sharded[name], mesh)
            for name in STEP_ENTRIES
        }
        kind = "halo-slab (B9) over %d x-slabs" % mesh.size
    kernels = {name: made[name] for name in STEP_ENTRIES}
    ops = b.ops

    def rhs(u, t):
        out = kernels["rhs"](u, t)
        for i, active in enumerate(ops._source_active):
            if active:
                src = ops.sources[i](t)
                if mesh is not None:
                    src = mesh.local(src)
                out[i] += src.to(torch.float32)
        return out

    return SimpleNamespace(build=b, kernels=kernels, mesh=mesh, kind=kind,
                           **dict(made, rhs=rhs))


def check_mesh(ops, mesh):
    """Refuse a mesh this problem cannot run on: anything but a
    parallel/mesh.py SlabMesh (what ``grid_mesh`` makes) of this
    problem's grid, and a split whose blocks are narrower than the
    operator's reach (``ops.reach``: the flux form reads ``2*sw`` rows,
    and a block takes halo rows from its next neighbours only)."""
    if not isinstance(mesh, SlabMesh):
        raise TypeError(
            "mesh %r: the port runs the meshes of parallel.grid_mesh "
            "(SlabMesh)" % type(mesh).__name__)
    if tuple(int(n) for n in mesh.grid.nps) != tuple(
            int(n) for n in ops.grid.nps):
        raise ValueError("the mesh splits a %s grid, the problem's is %s"
                         % (tuple(mesh.grid.nps), tuple(ops.grid.nps)))
    reach = int(getattr(ops, "reach", ops.sw))
    for d in mesh.padded_axes():
        if mesh.local_shape[d] < reach:
            raise ValueError(
                "mesh shape %s: %d rows of axis %s per rank, narrower than "
                "the stencil reach %d of this problem%s"
                % (mesh.shape, mesh.local_shape[d], mesh.axis_names[d],
                   reach, " (the flux form)" if reach > ops.sw else ""))


def mesh_kernel_refusal(mesh):
    """Why the halo-slab kernels cannot run on this mesh, or None.
    Counterpart: ksfd_tpu/ops/pallas_stencil.py:pallas_mesh_ok, whose
    kernels run only where the leading spatial axis is the only split
    one (the TPU's 8-row tiles are not carried over): a y or z split
    takes the unfused step, as the reference takes its XLA step."""
    if mesh is None or mesh.x_only:
        return None
    return ("a mesh %s that splits %s (the halo-slab kernels split x "
            "only, pallas_mesh_ok)" % (mesh.shape, "/".join(
                a for a, s in zip(mesh.axis_names, mesh.shape)
                if s > 1 and a != "x")))


def kernel_refusal(grid, ops):
    """Why the fused kernels cannot run this problem, or None.

    Counterpart: the refusals of ksfd_tpu/ops/pallas_stencil.py:321
    ``pallas_available`` and ops/pallas_stencil3d.py:162
    ``pallas3d_available`` that are not about the TPU: a 1D grid, a 3D
    extent under ``2*sw+1``, a with-G state (``dof != nligands+1``) and
    the flux form.  The TPU's alignment rules (128 lanes, 8-row x tiles)
    are not carried over: the CUDA kernels take any other extent.
    Time-dependent PDE coefficients are no refusal: each kernel reads t
    from its scalar pack (ops/codegen.py), and the step drops only the
    delta kernel there (``stage_delta_ok``), as the reference does."""
    if grid.dim not in (2, 3):
        return "a %dD grid (the kernels are 2D and 3D)" % grid.dim
    sw = int(ops.sw)
    if grid.dim == 3 and min(int(n) for n in grid.nps) < 2 * sw + 1:
        return ("a 3D extent under 2*sw+1 = %d (%s)"
                % (2 * sw + 1, tuple(int(n) for n in grid.nps)))
    if grid.dof != ops.nligands + 1:
        return "a with-G state (dof %d, %d fields)" % (grid.dof,
                                                         ops.nligands + 1)
    if getattr(ops, "flux_form", False):
        return "the flux form"
    return None


def kernels_available(grid, ops):
    """Whether the fused kernels run this problem (kernel_refusal):
    the gate the step asks before it builds them."""
    return kernel_refusal(grid, ops) is None


def make_fused_kernels(ops, mesh=None):
    """Build the fused kernels for a 2D or 3D PDEOperators.

    Counterpart: ksfd_tpu/ops/pallas_stencil.py:make_pallas_kernels,
    which hands 3D grids to make_pallas_kernels_3d (here:
    ops/fused_stencil3d.py).  Returns a namespace with ``jvp``,
    ``resid`` and ``delta`` (FusedKernel instances), ``rhs`` (the rhs
    kernel plus active sources), ``kernels`` (the four FusedKernels by
    name), ``coeff_resid`` (B11, 2D only) and ``build`` (header, build
    info).  Nothing is compiled until a kernel first meets a CUDA
    tensor.  Under ``torch.func.vmap`` each entry launches its
    member-batched build once for all members (module docstring).

    mesh: a parallel/mesh.py SlabMesh; the four step entries then take
    this rank's local slabs and run their halo-slab builds (B9, the
    counterpart of ``make_pallas_kernels(mesh=)``: pad_x :718-735 and
    shardwrap :737-755), with the f64 centring means global over the
    ranks.  B11 (``coeff_resid``) has no halo-slab build.

    A problem off the gate (kernel_refusal) raises ValueError: the step
    asks ``kernels_available`` first and takes the unfused step there,
    as the reference takes its XLA path.
    """
    if mesh is not None:
        check_mesh(ops, mesh)
    why = kernel_refusal(ops.grid, ops) or mesh_kernel_refusal(mesh)
    if why is not None:
        raise ValueError("no fused kernels for %s: the step takes the "
                         "unfused path (kernels_available)" % why)
    if ops.grid.dim == 3:
        from .fused_stencil3d import make_fused_kernels_3d

        return make_fused_kernels_3d(ops, mesh=mesh)
    src = "ksfd_tpu/ops/pallas_stencil.py"
    lines = dict(rhs=584, jvp=648, resid=655, delta=674)
    return kernel_namespace(_FusedBuild(ops), dict(
        {n: "%s:%d" % (src, k) for n, k in lines.items()},
        coeff_resid="tools/probe_coeff_kernel.py:114",
    ), mesh=mesh, sharded={
        n: "%s:%d sharded (pad_x :718, shardwrap :737)" % (src, k)
        for n, k in lines.items()})
