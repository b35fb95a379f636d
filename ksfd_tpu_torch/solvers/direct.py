"""Exact direct stage solves at any dimension by sparse LU.

Counterpart: ksfd_tpu/solvers/direct.py, the reference's MUMPS role
(its options84 block ``-ksp_type preonly -pc_type lu``) at any
dimension; solvers/banded_path.py is the 1D counterpart.

1. The W-operator (shift*I - J) couples a column (g, p) only to rows
   (f, q) with q within the axis cross of p of halfwidth 2*sw: the RHS
   is a sum over axes of two axis-aligned halfwidth-sw stencils around
   pointwise nonlinearities, with no mixed-axis coupling.  Its entries
   are extracted exactly by coloured probes, one per (axis phase,
   field), with a per-axis phase stride of at least 4*sw+1.
2. The probes run on the operators' device: ``torch.func.vmap`` over
   the J-action of ``PDEOperators.linearize`` (once per step); the
   assembly and scipy's SuperLU (``splu``) run on the host, as in the
   reference.
3. The assembled matrix is verified against the operator (two random
   matvecs) before factoring, so an operator with wider coupling fails
   loudly.

Selected by ``ksp_type='lu'``, and the host Solver's rescue tier.  On a
slab mesh (parallel/mesh.py) the exact tiers are the reference's
replicated host solve (ksfd_tpu/solvers/solver.py:1297-1307): every
rank gathers the global state (``SlabMesh.gather``), runs the identical
factorization and solves, and keeps its own rows (``place_like``):
``replicated_step`` wraps a one-card exact step so.
"""

import numpy as np
import torch
from torch.func import vmap

from ..utils.exceptions import KSFDException
from .steppers import wlte_norm_delta

__all__ = [
    "axis_strides",
    "extract_w_sparse",
    "make_sparse_step",
    "gather_global",
    "place_like",
    "replicated_step",
    "exact_stages",
]


def gather_global(u):
    """Host numpy copy of the state.  Counterpart: ksfd_tpu/solvers/
    direct.py:gather_global on one process; on a slab mesh
    ``replicated_step`` gathers the slabs on the device
    (``SlabMesh.gather``) before the one-card step's own copy."""
    return u.detach().cpu().numpy() if isinstance(u, torch.Tensor) \
        else np.asarray(u)


def place_like(u_np, like, mesh=None):
    """The host (or device) result as a tensor with ``like``'s device
    and dtype; with a ``mesh`` only this rank's rows of the global
    result.  Counterpart: ksfd_tpu/solvers/direct.py:place_like."""
    u = u_np if isinstance(u_np, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(u_np))
    if mesh is not None:
        u = mesh.local(u, first=1).contiguous()
    if isinstance(like, torch.Tensor):
        return u.to(device=like.device, dtype=like.dtype)
    return u


def replicated_step(step, mesh):
    """A one-card exact step ``(u, t, h) -> (u1, enorm)`` on a slab mesh:
    every rank gathers the global state, runs ``step`` on it (the
    identical factorization and solves), keeps its rows and returns the
    ranks' largest enorm, so every rank takes the same decision even
    where a device's rounding could differ.  The reference's replicated
    host solve (ksfd_tpu/solvers/direct.py:52 gather_global, :73
    place_like); the global state is bounded by the Solver's routing and
    rescue caps."""
    from ..parallel.mesh import all_reduce_max

    def rstep(u, t, h):
        u1, enorm = step(mesh.gather(u), t, h)
        return place_like(u1, u, mesh), all_reduce_max(enorm, mesh)

    return rstep


def axis_strides(nps, sw):
    """Per-axis colour strides: the smallest divisor of n_d that is at
    least 4*sw+1; a short axis falls back to n_d.  Counterpart:
    ksfd_tpu/solvers/direct.py:axis_strides."""
    need = 4 * int(sw) + 1
    strides = []
    for n in nps:
        n = int(n)
        s = n
        for cand in range(min(need, n), n + 1):
            if n % cand == 0:
                s = cand
                break
        strides.append(s)
    return tuple(strides)


def _cross_offsets(nps, sw):
    """Axis-cross offsets of halfwidth 2*sw (centre once), reduced mod
    the axis extent and deduplicated: on a short axis (n_d <= 4*sw)
    distinct offsets alias to one periodic neighbour, which the COO sum
    must count once.  Counterpart: ksfd_tpu/solvers/direct.py:
    _cross_offsets."""
    dim = len(nps)
    offs = [tuple([0] * dim)]
    for a in range(dim):
        seen = {0}
        for k in range(-2 * sw, 2 * sw + 1):
            km = k % int(nps[a])
            if km in seen:
                continue
            seen.add(km)
            d = [0] * dim
            d[a] = km
            offs.append(tuple(d))
    return offs


def extract_w_sparse(w_op, nps, dof, sw, *, verify=True,
                     max_chunk_bytes=1 << 28, w_batch=None, device="cpu"):
    """The exact scipy CSC matrix of a cross-coupled linear operator over
    the interleaved-dof ordering index(p, f) = lin(p)*dof + f (lin
    row-major).  Counterpart: ksfd_tpu/solvers/direct.py:
    extract_w_sparse.

    w_op: a linear callable on (dof, *nps) float64 tensors on
    ``device``; w_batch: its batched form on a stack of probes (default
    ``torch.func.vmap(w_op)``).  Probes go in chunks bounded by
    ``max_chunk_bytes`` of probe and response storage.
    """
    from scipy import sparse

    nps = tuple(int(n) for n in nps)
    dim = len(nps)
    dof = int(dof)
    sw = int(sw)
    strides = axis_strides(nps, sw)
    nphases = int(np.prod(strides))
    N_pts = int(np.prod(nps))
    N = N_pts * dof

    phase_grid = np.stack(
        np.meshgrid(*[np.arange(s) for s in strides], indexing="ij"),
        axis=-1,
    ).reshape(nphases, dim)
    offsets = _cross_offsets(nps, sw)
    coords = np.stack(
        np.meshgrid(*[np.arange(n) for n in nps], indexing="ij"),
        axis=-1,
    ).reshape(N_pts, dim)
    lin_strides = np.array(
        [int(np.prod(nps[a + 1:])) for a in range(dim)], dtype=np.int64
    )
    probe_bytes = 2 * dof * N_pts * 8  # probe + response, f64
    phases_per_chunk = max(1, int(max_chunk_bytes // (probe_bytes * dof)))

    rows_acc, cols_acc, vals_acc = [], [], []
    w_batch = w_batch if w_batch is not None else vmap(w_op)
    out_dtype = None
    deltas = np.asarray(offsets, dtype=np.int64)       # (noff, dim)
    noff = len(deltas)
    nps_arr = np.asarray(nps, dtype=np.int64)
    for start in range(0, nphases, phases_per_chunk):
        chunk = phase_grid[start:start + phases_per_chunk]
        nc = len(chunk)
        # probes: P[(c, g)] = ones at field g, points p = phase_c mod s
        P = np.zeros((nc * dof, dof) + nps)
        for ci, ph in enumerate(chunk):
            sel = tuple(
                slice(int(ph[a]), None, strides[a]) for a in range(dim)
            )
            for g in range(dof):
                P[(ci * dof + g, g) + sel] = 1.0
        WP = w_batch(torch.from_numpy(P).to(device)).cpu().numpy()
        out_dtype = WP.dtype
        for ci, ph in enumerate(chunk):
            # the columns of this phase, gathered and scattered at once
            # over (offset, point, field)
            mask = np.all(coords % strides == ph, axis=1)
            pcols = coords[mask]
            lin_p = pcols @ lin_strides
            q = (pcols[None, :, :] + deltas[:, None, :]) % nps_arr
            qf = q.reshape(-1, dim)
            lin_q = qf @ lin_strides
            col_lin = np.tile(lin_p, noff)
            idx = tuple(qf.T)
            for g in range(dof):
                resp = WP[ci * dof + g]
                vals = resp[(slice(None),) + idx]      # (dof, noff*npc)
                f_idx, e_idx = np.nonzero(vals)
                if not len(f_idx):
                    continue
                rows_acc.append(lin_q[e_idx] * dof + f_idx)
                cols_acc.append(col_lin[e_idx] * dof + g)
                vals_acc.append(vals[f_idx, e_idx])
    rows = np.concatenate(rows_acc) if rows_acc else np.zeros(0, int)
    cols = np.concatenate(cols_acc) if cols_acc else np.zeros(0, int)
    vals = np.concatenate(vals_acc) if vals_acc else np.zeros(0)
    A = sparse.coo_matrix((vals, (rows, cols)), shape=(N, N)).tocsc()

    if verify:
        # two random matvecs: a coupling wider than the axis cross
        # fails here; the gate scales with the operator's dtype
        tol = 1e-9 if np.dtype(out_dtype).itemsize >= 8 else 1e-4
        rng = np.random.default_rng(12345)
        for _ in range(2):
            v = rng.standard_normal((dof,) + nps)
            want = w_op(torch.from_numpy(v).to(device)).cpu().numpy()
            vi = np.moveaxis(v, 0, -1).reshape(-1)
            got = np.moveaxis((A @ vi).reshape(nps + (dof,)), -1, 0)
            scale = np.max(np.abs(want)) or 1.0
            if np.max(np.abs(got - want)) > tol * scale:
                raise KSFDException(
                    "sparse W assembly does not reproduce the operator "
                    "(max dev %.3e of %.3e): coupling exceeds the "
                    "axis-cross support assumed by ksp_type=lu"
                    % (float(np.max(np.abs(got - want))), float(scale))
                )
    return A


def exact_stages(ops, tab, atol, rtol, u, t, h, solve):
    """One Rosenbrock-W step of ``tab`` from the groomed host state u
    (numpy) with exact stage solves ``solve(b) -> y`` on host arrays:
    the stage sums on the host, each stage RHS ``ops.rhs`` on the
    operators' device, the solution and embedded-difference sums from
    the exact (m2_j - m_j) weights (make_banded_step and
    make_sparse_step of the reference share this loop).  Returns (u1
    numpy, enorm float)."""
    dev = ops.device
    Ys = []
    for i in range(tab.stages):
        Ui = u.copy()
        for jj in range(i):
            if tab.a[i][jj]:
                Ui = Ui + tab.a[i][jj] * Ys[jj]
        ti = torch.tensor(t + tab.alpha[i] * h, dtype=torch.float64,
                          device=dev)
        bi = ops.rhs(torch.from_numpy(Ui).to(dev), ti).cpu().numpy()
        for jj in range(i):
            if tab.c[i][jj]:
                bi = bi + (tab.c[i][jj] / h) * Ys[jj]
        Ys.append(solve(bi))
    u1 = u.copy()
    d = np.zeros_like(u)
    for jj in range(tab.stages):
        u1 = u1 + tab.m[jj] * Ys[jj]
        dm = tab.m2[jj] - tab.m[jj]
        if dm:
            d = d + dm * Ys[jj]
    enorm = float(wlte_norm_delta(torch.from_numpy(u1),
                                  torch.from_numpy(d), atol, rtol))
    return u1, enorm


def w_operator(ops, u, t, shift):
    """``(w_op, w_batch)``: v -> shift*v - J(u) v at the state u (a
    tensor on the operators' device) and time t, J from
    ``PDEOperators.linearize`` once, and its vmapped form on a stack of
    probes."""
    dev = ops.device
    _, jvp = ops.linearize(u, torch.tensor(t, dtype=torch.float64,
                                           device=dev), primal=False)

    def w_op(v):
        return shift * v - jvp(v)

    return w_op, vmap(w_op)


def make_sparse_step(ops, tab, atol, rtol):
    """Host step with sparse-LU stage solves, the contract of
    make_step_fn's step: ``(u, t, h) -> (u1, enorm)``, u1 a tensor like
    u and enorm a 0-d float64 tensor on its device.  Counterpart:
    ksfd_tpu/solvers/direct.py:make_sparse_step.  The probes and stage
    RHS run on the operators' device; the assembly, one SuperLU
    factorization per step (shift and J are fixed over the stages) and
    the triangular solves on the host (on a slab mesh wrapped in
    ``replicated_step``)."""
    from scipy.sparse.linalg import splu

    grid = ops.grid
    nps = tuple(int(n) for n in grid.nps)
    dof = grid.dof
    sw = grid.stencil_width

    def step(u, t, h):
        u_in = u
        ug = ops.groom(torch.as_tensor(u, device=ops.device))
        u = gather_global(ug)
        t, h = float(t), float(h)
        w_op, w_batch = w_operator(ops, ug, t, 1.0 / (h * tab.gamma))
        A = extract_w_sparse(w_op, nps, dof, sw, w_batch=w_batch,
                             device=ops.device)
        lu = splu(A)

        def solve(b):
            # interleaved-dof ordering: index (p, f) = lin(p)*dof + f
            y = lu.solve(np.moveaxis(b, 0, -1).reshape(-1))
            return np.moveaxis(y.reshape(nps + (dof,)), -1, 0).copy()

        u1, enorm = exact_stages(ops, tab, atol, rtol, u, t, h, solve)
        return place_like(u1, u_in), _enorm(enorm, u_in)

    return step


def _enorm(enorm, like):
    dev = like.device if isinstance(like, torch.Tensor) else "cpu"
    return torch.tensor(enorm, dtype=torch.float64, device=dev)
