"""Fused float32 stencil kernels on 3D grids: rhs, jvp, resid and delta.

Counterpart: ksfd_tpu/ops/pallas_stencil3d.py:make_pallas_kernels_3d.
``make_fused_kernels_3d(ops)`` (reached through
``fused_stencil.make_fused_kernels`` for a 3D grid) returns the same
namespace as the 2D build, with the same entries, call signatures and
scalar packs (pallas_stencil3d.py:603-654):

- ``rhs(u, t)``, ``sc=[t, mean_0..mean_{dof-1}, G(means),
  react_1..react_{dof-1}]`` from float64 means of the groomed view:
  the float32 fast mode's full RHS, centred on the means; active
  sources added after the launch.  Replaces ``rhs_kernel``
  (pallas_stencil3d.py:366, scalar pack :603-617).
- ``jvp(u, v, t)``, ``sc=[t]``: the exact J-action J(u)v.  Replaces
  ``jvp_kernel`` (pallas_stencil3d.py:419, rows from ``_jvp_rows``
  :390).
- ``resid(u, v, b, t, shift)``, ``sc=[t, shift]``: the fused
  Richardson residual ``b - (shift*v - J(u)v)``.  Replaces
  ``resid_kernel`` (:426).
- ``delta(u0, d, u1, t)``, ``sc=[t, rho_mean, G_mean]`` from float64
  means of the groomed view: ``rhs(u1) - rhs(u0)`` through G_delta.
  Replaces ``delta_kernel`` (:440).

The operands keep the natural ``(dof, nx, ny, nz)`` layout, z
contiguous; the TPU's folded ``(dof, nx, ny*nz)`` lane layout and its
tile planner (``_tile_plan3d``) answer Mosaic's 128-lane alignment and
are not carried over, so any ``nx, ny, nz >= 2*sw + 1`` is accepted
(fused_stencil.kernel_refusal; a smaller extent takes the unfused
step).
On a CUDA tensor each entry launches its kernel in csrc/stencil3d.cu
(a library of its own, built at first use); on a CPU tensor it runs
the plain PyTorch version of fused_stencil._FusedBuild, whose
``torch.roll`` stencils sum over x, then y, then z, the order of the
Pallas ``lap``/``graddot``.

Under ``torch.func.vmap`` each entry makes one member-batched launch
(B8 in 3D, the counterpart of the ``batch=B`` build,
pallas_stencil3d.py:191-192, :246-260, and its vmap rule :578-582):
the vmap rule of ops/fused_stencil.py, the members the slowest part of
a 1D block index (csrc/stencil3d.cu).

With a ``mesh`` (parallel/mesh.py) the entries are the halo-slab builds
(B9 in 3D, pallas_stencil3d.py pad_x :474 and shardwrap :488) on this
rank's slab, as ops/fused_stencil.py describes for 2D.
"""

from .fused_stencil import CSRC, _FusedBuild, kernel_namespace

__all__ = ["make_fused_kernels_3d", "CSRC3D"]

CSRC3D = CSRC.parent / "stencil3d.cu"


def make_fused_kernels_3d(ops, mesh=None):
    """Build the fused kernels for a 3D PDEOperators; with a ``mesh``
    (parallel/mesh.py SlabMesh) the halo-slab builds (B9 in 3D,
    pallas_stencil3d.py pad_x :474 and shardwrap :488) on this rank's
    slab."""
    if ops.grid.dim != 3:
        raise ValueError("make_fused_kernels_3d needs a 3D grid")
    src = "ksfd_tpu/ops/pallas_stencil3d.py"
    lines = dict(rhs=366, jvp=419, resid=426, delta=440)
    return kernel_namespace(
        _FusedBuild(ops, CSRC3D),
        {n: "%s:%d" % (src, k) for n, k in lines.items()}, mesh=mesh,
        sharded={n: "%s:%d sharded (pad_x :474, shardwrap :488)"
                 % (src, k) for n, k in lines.items()})
