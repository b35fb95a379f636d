"""The x-slab mesh: the grid split along x over torch.distributed ranks.

Counterpart: ksfd_tpu/parallel/mesh.py.  The reference shards the
state array over a JAX device mesh and lets XLA insert the halo
collectives; its fused kernels run only on x-only splits, each shard
padded with ``sw`` halo rows from its ring neighbours
(ops/pallas_stencil.py ``pad_x``, ``ppermute`` both ways).  The port
runs one process (rank) per slab: a rank holds only its local
``(dof, nx/n_x, ny[, nz])`` slab on its device, and the same halo rows
travel between ranks here:

- ``halo_rows(u_loc, sw, mesh) -> (lo, hi)``: the ``sw`` rows below and
  above the slab, each a contiguous ``(dof, sw, ny[, nz])`` block, the
  ring closed periodically (the reference's DMDA boundary type).  With
  NCCL, one ``batch_isend_irecv`` of the card's tensors; with gloo,
  whose send and recv take only host tensors, the rows go through the
  host (the transport of that backend, which the caller chose); on one
  rank, the slab's own wrap rows, with no communication.
- ``all_reduce_sum/max/min``: the mesh-wide reductions (global means,
  the pc statistics, the error norm, the CFL bound).  Every rank gets
  the same value, so every rank takes the same decision from it.

Only x splits ``(n, 1[, 1])`` run; any other shape raises
NotImplementedError (on the reference a y split loses its kernels and
runs the XLA path).  ``nx`` must divide over the ranks with at least
``sw`` rows each, so a slab never needs rows from two neighbours away.
"""

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device

__all__ = [
    "SlabMesh",
    "grid_mesh",
    "state_sharding",
    "distribute",
    "mesh_shape_for",
    "halo_rows",
    "exchange_halos",
    "all_reduce_sum",
    "all_reduce_max",
    "all_reduce_min",
]

SPATIAL_AXES = ("x", "y", "z")

#: the ROADMAP item that lists what the slab mesh does not run yet
MESH_TODO = "ROADMAP Queue A item 11 (A14)"


def mesh_shape_for(n_devices, grid_dims, nps=None):
    """Split n_devices over up to grid_dims mesh axes.  Counterpart:
    ksfd_tpu/parallel/mesh.py:mesh_shape_for (a copy, with the same
    answers): an x-only split
    whenever ``nx % (8 * n_devices) == 0``, else the most balanced
    factoring; each axis count is capped by and divides its points."""
    if grid_dims == 1:
        shape = [n_devices]
    elif (
        nps is not None
        and n_devices > 1
        and int(nps[0]) % (8 * n_devices) == 0
    ):
        shape = [n_devices] + [1] * (grid_dims - 1)
    else:
        shape = [1] * grid_dims
        n = n_devices
        f = 2
        factors = []
        while f * f <= n:
            while n % f == 0:
                factors.append(f)
                n //= f
            f += 1
        if n > 1:
            factors.append(n)
        for fac in sorted(factors, reverse=True):
            i = int(np.argmin(shape))
            shape[i] *= fac
    if nps is not None:
        for i in range(grid_dims):
            npts = max(1, int(nps[i]))
            while shape[i] > 1 and (shape[i] > npts or npts % shape[i]):
                shape[i] //= 2
    return tuple(shape)


class SlabMesh:
    """One rank's view of the grid's x split over a process group.

    Holds the group, ``n_x`` (ranks, each one slab), this rank, the
    backend, the rank's ``device`` and the slab's rows ``[x0, x1)`` of
    the global ``nx``.  ``devices`` lists every rank's device; with
    NCCL two ranks on one device raise (NCCL cannot pair them).
    """

    def __init__(self, grid, group, n_x, rank, backend, device, devices):
        dim = grid.dim
        if dim not in (2, 3):
            raise NotImplementedError(
                "the slab mesh runs 2D and 3D grids; a 1D mesh is ROADMAP "
                "Queue A item 11 (A14)")
        nx = int(grid.nps[0])
        sw = int(grid.stencil_width)
        if nx % n_x or nx // n_x < sw:
            raise ValueError(
                "an x split over %d ranks needs nx (%d) divisible by it with "
                "at least sw=%d rows per slab" % (n_x, nx, sw))
        if backend == "nccl" and len(set(devices)) < len(devices):
            raise ValueError(
                "NCCL cannot run two ranks on one device (devices %s); use "
                "one card per rank, or the gloo backend" % list(devices))
        self.grid = grid
        self.group = group
        self.n_x = int(n_x)
        self.rank = int(rank)
        self.backend = backend
        self.device = torch.device(device)
        self.devices = tuple(devices)
        self.nx = nx
        self.nx_loc = nx // self.n_x
        self.x0 = self.rank * self.nx_loc
        self.x1 = self.x0 + self.nx_loc
        self.shape = (self.n_x,) + (1,) * (dim - 1)
        self.axis_names = SPATIAL_AXES[:dim]
        self.n_points = int(np.prod(grid.nps))

    @property
    def local_shape(self):
        """The slab's spatial shape ``(nx/n_x, ny[, nz])``."""
        return (self.nx_loc,) + tuple(int(n) for n in self.grid.nps[1:])

    def rows(self, a, axis=0):
        """This rank's rows ``[x0, x1)`` of a global array along
        ``axis`` (a source term, a basis matrix)."""
        return a.narrow(axis, self.x0, self.nx_loc)

    def cut(self, u, sw):
        """``(slab, lo, hi)`` of this rank from a global state ``u``: its
        rows and the ``sw`` rows on each side, wrapped periodically (what
        ``distribute`` and ``halo_rows`` give, taken in one process)."""
        idx = lambda a, b: torch.arange(a, b, device=u.device) % self.nx
        return tuple(u.index_select(1, idx(a, b)).contiguous() for a, b in (
            (self.x0, self.x1), (self.x0 - sw, self.x0),
            (self.x1, self.x1 + sw)))

    def gather(self, u_loc):
        """The global state ``(dof, nx, ...)`` from every rank's slab,
        on every rank (an all_gather; for checks and output)."""
        parts = [torch.empty_like(u_loc) for _ in range(self.n_x)]
        if self.n_x == 1:
            parts[0].copy_(u_loc)
        elif self.backend == "gloo" and u_loc.device.type != "cpu":
            host = [torch.empty_like(p, device="cpu") for p in parts]
            dist.all_gather(host, u_loc.cpu(), group=self.group)
            parts = [h.to(u_loc.device) for h in host]
        else:
            dist.all_gather(parts, u_loc.contiguous(), group=self.group)
        return torch.cat(parts, dim=1)

    def __repr__(self):
        return ("SlabMesh(n_x=%d, rank=%d, backend=%r, device=%s, rows "
                "[%d, %d) of %d)" % (self.n_x, self.rank, self.backend,
                                     self.device, self.x0, self.x1, self.nx))


def _rank_devices(group, backend, device):
    """Every rank's device, gathered over a gloo group (an NCCL
    collective would fail before the check if two ranks share a card)."""
    n = dist.get_world_size(group)
    if n == 1:
        return [str(device)]
    side = group
    if backend != "gloo":
        side = dist.new_group(ranks=dist.get_process_group_ranks(group)
                              if group is not None else None,
                              backend="gloo")
    out = [None] * n
    dist.all_gather_object(out, str(device), group=side)
    if side is not group:
        dist.destroy_process_group(side)
    return out


def grid_mesh(grid, group=None, shape=None, device=None):
    """The slab mesh of this rank over ``group`` (the default group when
    None; torch.distributed must be initialized, e.g. by
    parallel.distributed.maybe_init_distributed).  Counterpart:
    ksfd_tpu/parallel/mesh.py:grid_mesh.

    shape: the mesh shape per spatial axis; ``mesh_shape_for`` of the
    group's size when None.  Only ``(n, 1[, 1])`` runs, over all the
    group's ranks.  device: this rank's device; the current card when
    None (utils/device.py: the card unless the caller names the CPU).
    """
    if not dist.is_available() or not dist.is_initialized():
        raise RuntimeError(
            "grid_mesh needs an initialized torch.distributed process "
            "group (parallel.maybe_init_distributed)")
    n = dist.get_world_size(group)
    rank = dist.get_rank(group)
    backend = dist.get_backend(group)
    if shape is None:
        shape = mesh_shape_for(n, grid.dim, grid.nps)
    shape = tuple(int(s) for s in shape)
    if len(shape) != grid.dim or any(s != 1 for s in shape[1:]):
        raise NotImplementedError(
            "mesh shape %s: the port splits x only, (n, 1[, 1]); y and z "
            "splits are %s" % (shape, MESH_TODO))
    if shape[0] != n:
        raise ValueError(
            "mesh shape %s does not use the group's %d ranks" % (shape, n))
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    devices = _rank_devices(group, backend, device)
    return SlabMesh(grid, group, shape[0], rank, backend, device, devices)


def state_sharding(mesh):
    """The state's layout over the mesh, as the reference's
    PartitionSpec reads: the dof axis whole, x split, the rest whole.
    Counterpart: ksfd_tpu/parallel/mesh.py:state_sharding."""
    return (None,) + mesh.axis_names[:1] + (None,) * (len(mesh.shape) - 1)


def distribute(u, grid, mesh):
    """This rank's slab of a global state (numpy or tensor, ``(dof, nx,
    ...)``), on the mesh's device.  Returns ``(u_loc, mesh)`` as
    ksfd_tpu/parallel/mesh.py:distribute returns the placed array and
    its mesh."""
    u = torch.as_tensor(np.asarray(u) if not isinstance(u, torch.Tensor)
                        else u)
    if tuple(u.shape[1:]) != tuple(int(n) for n in grid.nps):
        raise ValueError("distribute takes the global state; got shape %s"
                         % (tuple(u.shape),))
    return mesh.rows(u, axis=1).contiguous().to(mesh.device), mesh


def _wrap(xs, sw):
    """The one-rank ring: each slab's own wrap rows."""
    return [(x[:, -sw:].contiguous(), x[:, :sw].contiguous()) for x in xs]


def exchange_halos(xs, sw, mesh):
    """``halo_rows`` of several slabs of one dtype and shape in one
    exchange: a list of ``(lo, hi)``, each contiguous.  Profiled as
    ``ksfd::halo``."""
    with torch.profiler.record_function("ksfd::halo"):
        return _exchange(xs, sw, mesh)


def _exchange(xs, sw, mesh):
    if mesh.n_x == 1:
        return _wrap(xs, sw)
    n, r = mesh.n_x, mesh.rank
    # strided row blocks (the dof planes) copied into contiguous buffers
    up = torch.stack([x[:, -sw:] for x in xs])    # to the right: its lo
    down = torch.stack([x[:, :sw] for x in xs])   # to the left: its hi
    lo, hi = torch.empty_like(up), torch.empty_like(down)
    via_host = mesh.backend == "gloo" and up.device.type != "cpu"
    if via_host:
        up, down = up.cpu(), down.cpu()
        lo_t, hi_t = torch.empty_like(up), torch.empty_like(down)
    else:
        lo_t, hi_t = lo, hi
    right = dist.get_global_rank(mesh.group, (r + 1) % n) \
        if mesh.group is not None else (r + 1) % n
    left = dist.get_global_rank(mesh.group, (r - 1) % n) \
        if mesh.group is not None else (r - 1) % n
    # the same order on every rank (and a tag per direction), so that
    # with two ranks, where left and right are one peer, the two
    # messages each way pair up
    ops = [dist.P2POp(dist.isend, up, right, mesh.group, tag=0),
           dist.P2POp(dist.isend, down, left, mesh.group, tag=1),
           dist.P2POp(dist.irecv, lo_t, left, mesh.group, tag=0),
           dist.P2POp(dist.irecv, hi_t, right, mesh.group, tag=1)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    if via_host:
        lo.copy_(lo_t)
        hi.copy_(hi_t)
    return [(lo[i], hi[i]) for i in range(len(xs))]


def halo_rows(u_loc, sw, mesh):
    """The ``sw`` rows below (``lo``: the left neighbour's last rows)
    and above (``hi``: the right neighbour's first rows) the slab
    ``u_loc`` (``(dof, nx_loc, ...)``), each contiguous, the ring closed
    periodically.  Counterpart: the ``ppermute`` pair of
    ksfd_tpu/ops/pallas_stencil.py:pad_x (its concatenate is left to
    the caller)."""
    return exchange_halos([u_loc], sw, mesh)[0]


def _all_reduce(x, op, mesh):
    """A reduced copy of x, profiled as ``ksfd::all_reduce``.  One rank
    still calls the backend when a process group runs (a one-rank NCCL
    mesh drives the whole sharded path); a mesh made without one (a
    single process's view of an x split) reduces over itself."""
    x = torch.as_tensor(x).clone()
    if mesh.n_x == 1 and not dist.is_initialized():
        return x
    with torch.profiler.record_function("ksfd::all_reduce"):
        return _reduce(x, op, mesh)


def _reduce(x, op, mesh):
    if mesh.backend == "gloo" and x.device.type != "cpu":
        # gloo's transport is the host: stage the tensor there, as the
        # halo rows are, so a CUDA tensor takes the path the CPU runs
        h = x.cpu()
        dist.all_reduce(h, op=op, group=mesh.group)
        return h.to(x.device)
    dist.all_reduce(x, op=op, group=mesh.group)
    return x


def all_reduce_sum(x, mesh):
    """The sum of ``x`` over the mesh's ranks (a new tensor)."""
    return _all_reduce(x, dist.ReduceOp.SUM, mesh)


def all_reduce_max(x, mesh):
    """The elementwise maximum over the ranks (a new tensor)."""
    return _all_reduce(x, dist.ReduceOp.MAX, mesh)


def all_reduce_min(x, mesh):
    """The elementwise minimum over the ranks (a new tensor)."""
    return _all_reduce(x, dist.ReduceOp.MIN, mesh)
