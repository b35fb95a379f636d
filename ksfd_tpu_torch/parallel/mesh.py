"""The slab mesh: the grid split into boxes over torch.distributed ranks.

Counterpart: ksfd_tpu/parallel/mesh.py.  The reference shards the
state array over a JAX device mesh of shape ``(px[, py[, pz]])`` and
lets XLA insert the halo collectives; its fused kernels run only on
x-only splits, each shard padded with ``sw`` halo rows from its ring
neighbours (ops/pallas_stencil.py ``pad_x``, ``ppermute`` both ways).
The port runs one process (rank) per box: a rank holds only its local
``(dof, nx/px[, ny/py[, nz/pz]])`` block on its device, rank r at the
mesh coordinates ``np.unravel_index(r, shape)`` (the reference's
``devices.reshape(shape)``), and the same halo rows travel between
ranks here:

- ``halo_rows(u_loc, sw, mesh)`` / ``exchange_halos``: the ``sw`` rows
  below and above the block along one axis (x unless named), each a
  contiguous block, the ring closed periodically (the reference's
  DMDA boundary type).  With NCCL, one ``batch_isend_irecv`` of the
  card's tensors; with gloo, whose send and recv take only host
  tensors, the rows go through the host (the transport of that
  backend, which the caller chose); along an axis of one rank, the
  block's own wrap rows, with no communication.
- ``SlabMesh.pad``/``crop``: the block padded by ``width`` rows of its
  neighbours along x and along every other split axis, one axis after
  the other, so the corners hold the diagonal neighbours' rows (the
  stencils are stars and read none, but the padded array is whole).
  An unsplit axis is not padded: the periodic roll wraps it.
- ``all_reduce_sum/max/min``: the mesh-wide reductions (global means,
  the pc statistics, the error norm, the CFL bound).  Every rank gets
  the same value, so every rank takes the same decision from it.

The pad, the reductions and ``gather`` run as custom ops whose vmap
rule makes ONE collective for all members under ``torch.func.vmap``
(an ensemble's members, each split over the mesh): a collective
cannot run on a batched tensor.

Each split axis must divide its points with at least ``sw`` rows per
rank, so a block never needs rows from two neighbours away (the flux
form reads ``2*sw``: ops/fused_stencil.py ``check_mesh`` asks for that
many).
"""

import itertools
import weakref

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device
from ..utils.spans import span

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


_OPS = [dist.ReduceOp.SUM, dist.ReduceOp.MAX, dist.ReduceOp.MIN]

#: live meshes by key: the vmap custom ops carry the key, not the mesh
_MESHES = weakref.WeakValueDictionary()
_NEXT_KEY = itertools.count()


class SlabMesh:
    """One rank's view of the grid's split over a process group.

    Holds the group, the mesh ``shape`` (ranks per spatial axis), this
    rank and its mesh ``coords``, the backend, the rank's ``device``
    and its ``box``, ``((lo, hi), ...)`` per axis of the global grid.
    ``devices`` lists every rank's device; with NCCL two ranks on one
    device raise (NCCL cannot pair them).
    """

    def __init__(self, grid, group, shape, rank, backend, device, devices):
        dim = grid.dim
        shape = tuple(int(s) for s in shape)
        if len(shape) != dim or min(shape) < 1:
            raise ValueError("mesh shape %s for a %dD grid" % (shape, dim))
        nps = tuple(int(n) for n in grid.nps)
        sw = int(grid.stencil_width)
        for d, (n, s) in enumerate(zip(nps, shape)):
            if n % s or n // s < sw:
                raise ValueError(
                    "a split of axis %s over %d ranks needs n%s (%d) "
                    "divisible by it with at least sw=%d rows per slab"
                    % (SPATIAL_AXES[d], s, SPATIAL_AXES[d], n, sw))
        if backend == "nccl" and len(set(devices)) < len(devices):
            raise ValueError(
                "NCCL cannot run two ranks on one device (devices %s); use "
                "one card per rank, or the gloo backend" % list(devices))
        self.grid = grid
        self.group = group
        self.shape = shape
        self.size = int(np.prod(shape))
        self.rank = int(rank)
        self.coords = tuple(int(c) for c in np.unravel_index(self.rank,
                                                             shape))
        self.backend = backend
        self.device = torch.device(device)
        self.devices = tuple(devices)
        self.dim = dim
        self.nps = nps
        ext = [n // s for n, s in zip(nps, shape)]
        self.box = tuple((c * e, (c + 1) * e)
                         for c, e in zip(self.coords, ext))
        self.local_shape = tuple(ext)
        #: True where only x is split: the halo-slab kernels (B9) run
        self.x_only = all(s == 1 for s in shape[1:])
        self.axis_names = SPATIAL_AXES[:dim]
        self.n_points = int(np.prod(nps))
        self.key = next(_NEXT_KEY)
        _MESHES[self.key] = self

    def padded_axes(self):
        """The spatial axes ``pad`` pads: the split ones."""
        return [d for d in range(self.dim) if self.shape[d] > 1]

    def axis_rows(self, a, d, axis=0):
        """This rank's rows of spatial axis ``d`` of an array along its
        ``axis`` (axis d's basis matrix)."""
        lo, hi = self.box[d]
        return a.narrow(axis, lo, hi - lo)

    def local(self, a, first=0):
        """This rank's block of a global array whose spatial axes start
        at ``first`` (a source term, a noise draw, a global state)."""
        for d, (lo, hi) in enumerate(self.box):
            a = a.narrow(first + d, lo, hi - lo)
        return a

    def cut(self, u, sw):
        """``(slab, lo, hi)`` of this rank of an x split from a global
        state ``u``: its rows and the ``sw`` rows on each side, wrapped
        periodically (what ``distribute`` and ``halo_rows`` give, taken
        in one process)."""
        x0, x1 = self.box[0]
        idx = lambda a, b: torch.arange(a, b, device=u.device) % self.nps[0]
        return tuple(u.index_select(1, idx(a, b)).contiguous() for a, b in (
            (x0, x1), (x0 - sw, x0), (x1, x1 + sw)))

    def pad(self, u, width):
        """The block ``u`` (its spatial axes last) padded by ``width``
        rows of its neighbours along each of ``padded_axes``, one
        exchange per axis (under vmap, one for all members); an
        unsplit mesh returns ``u``.  Profiled as ``ksfd::halo``."""
        if not self.padded_axes():
            return u
        return _pad_op(u, self.key, int(width))

    def crop(self, p, width):
        """The block's own points of a ``pad``-ded array."""
        lead = p.dim() - self.dim
        for d in self.padded_axes():
            p = p.narrow(lead + d, width, p.shape[lead + d] - 2 * width)
        return p

    def gather(self, u_loc):
        """The global state from every rank's block (its spatial axes
        last), on every rank (an all_gather; for checks, output and the
        replicated solves)."""
        return _gather_op(u_loc, self.key)

    def __repr__(self):
        return ("SlabMesh(shape=%s, rank=%d, backend=%r, device=%s, box %s "
                "of %s)" % (self.shape, self.rank, self.backend, self.device,
                            self.box, self.nps))


def _gather(u_loc, mesh):
    lead = u_loc.dim() - mesh.dim
    if mesh.size == 1:
        return u_loc.clone()
    parts = [torch.empty_like(u_loc) for _ in range(mesh.size)]
    if mesh.backend == "gloo" and u_loc.device.type != "cpu":
        host = [torch.empty_like(p, device="cpu") for p in parts]
        dist.all_gather(host, u_loc.contiguous().cpu(), group=mesh.group)
        parts = [h.to(u_loc.device) for h in host]
    else:
        dist.all_gather(parts, u_loc.contiguous(), group=mesh.group)
    out = u_loc.new_empty(tuple(u_loc.shape[:lead]) + mesh.nps)
    ext = mesh.local_shape
    for r, part in enumerate(parts):
        coords = np.unravel_index(r, mesh.shape)
        idx = (slice(None),) * lead + tuple(
            slice(c * e, (c + 1) * e) for c, e in zip(coords, ext))
        out[idx] = part
    return out


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
    """The mesh of this rank over ``group`` (the default group when
    None; torch.distributed must be initialized, e.g. by
    parallel.distributed.maybe_init_distributed).  Counterpart:
    ksfd_tpu/parallel/mesh.py:grid_mesh.

    shape: the mesh shape per spatial axis; ``mesh_shape_for`` of the
    group's size when None, as the reference decides.  The shape must
    use every rank of the group: where ``mesh_shape_for`` leaves ranks
    over (a grid too small or too odd for them) this raises ValueError
    rather than leave a process idle.  device: this rank's device; the
    current card when None (utils/device.py: the card unless the caller
    names the CPU).
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
    if len(shape) != grid.dim:
        raise ValueError("mesh shape %s for a %dD grid" % (shape, grid.dim))
    if int(np.prod(shape)) != n:
        raise ValueError(
            "mesh shape %s uses %d ranks, the group has %d (the grid %s "
            "does not split over them); run with a rank count that "
            "divides it" % (shape, int(np.prod(shape)), n,
                            tuple(int(k) for k in grid.nps)))
    device = resolve_device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    devices = _rank_devices(group, backend, device)
    return SlabMesh(grid, group, shape, rank, backend, device, devices)


def state_sharding(mesh):
    """The state's layout over the mesh, as the reference's
    PartitionSpec reads: the dof axis whole, each spatial axis over its
    mesh axis.  Counterpart: ksfd_tpu/parallel/mesh.py:state_sharding."""
    return (None,) + tuple(mesh.axis_names)


def distribute(u, grid, mesh):
    """This rank's block of a global state (numpy or tensor, ``(dof,
    nx, ...)``), on the mesh's device.  Returns ``(u_loc, mesh)`` as
    ksfd_tpu/parallel/mesh.py:distribute returns the placed array and
    its mesh."""
    u = torch.as_tensor(np.asarray(u) if not isinstance(u, torch.Tensor)
                        else u)
    if tuple(u.shape[1:]) != tuple(int(n) for n in grid.nps):
        raise ValueError("distribute takes the global state; got shape %s"
                         % (tuple(u.shape),))
    return mesh.local(u, first=1).contiguous().to(mesh.device), mesh


def _rank_at(mesh, coords):
    r = int(np.ravel_multi_index(coords, mesh.shape))
    return dist.get_global_rank(mesh.group, r) if mesh.group is not None \
        else r


def exchange_halos(xs, sw, mesh, axis=0):
    """``halo_rows`` of several blocks of one dtype and shape in one
    exchange along spatial ``axis``: a list of ``(lo, hi)``, each
    contiguous.  Profiled as ``ksfd::halo`` (utils/spans.py)."""
    with span("halo"):
        return _exchange(xs, sw, mesh, axis, xs[0].dim() - mesh.dim)


def _exchange(xs, sw, mesh, axis, lead):
    ax = lead + axis
    n_ax = xs[0].shape[ax]
    if mesh.shape[axis] == 1:
        # the one-rank ring along this axis: the block's own wrap rows
        return [(x.narrow(ax, n_ax - sw, sw).contiguous(),
                 x.narrow(ax, 0, sw).contiguous()) for x in xs]
    # strided row blocks copied into contiguous buffers (gloo stages
    # them on the host as they are)
    up = torch.stack([x.narrow(ax, n_ax - sw, sw) for x in xs])  # its lo
    down = torch.stack([x.narrow(ax, 0, sw) for x in xs])        # its hi
    lo, hi = torch.empty_like(up), torch.empty_like(down)
    via_host = mesh.backend == "gloo" and up.device.type != "cpu"
    if via_host:
        up, down = up.cpu(), down.cpu()
        lo_t, hi_t = torch.empty_like(up), torch.empty_like(down)
    else:
        lo_t, hi_t = lo, hi
    n = mesh.shape[axis]
    c = list(mesh.coords)
    c[axis] = (mesh.coords[axis] + 1) % n
    right = _rank_at(mesh, c)
    c[axis] = (mesh.coords[axis] - 1) % n
    left = _rank_at(mesh, c)
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


def halo_rows(u_loc, sw, mesh, axis=0):
    """The ``sw`` rows below (``lo``: the left neighbour's last rows)
    and above (``hi``: the right neighbour's first rows) the block
    ``u_loc`` along spatial ``axis``, each contiguous, the ring closed
    periodically.  Counterpart: the ``ppermute`` pair of
    ksfd_tpu/ops/pallas_stencil.py:pad_x (its concatenate is left to
    the caller)."""
    return exchange_halos([u_loc], sw, mesh, axis=axis)[0]


def _pad(u, mesh, width):
    lead = u.dim() - mesh.dim
    with span("halo"):
        for d in mesh.padded_axes():
            lo, hi = _exchange([u], width, mesh, d, lead)[0]
            u = torch.cat([lo, u, hi], dim=lead + d)
    return u


def _all_reduce(x, op, mesh):
    """A reduced copy of x (``op`` indexes ``_OPS``: sum, max, min),
    profiled as ``ksfd::all_reduce``.  One rank still calls the
    backend when a process group runs (a one-rank NCCL mesh drives the
    whole sharded path); a mesh made without one (a single process's
    view of a split) reduces over itself."""
    return _reduce_op(torch.as_tensor(x), mesh.key, op)


def _reduce_any(x, op, mesh):
    x = x.clone()
    if mesh.size == 1 and not dist.is_initialized():
        return x
    with span("all_reduce"):
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


# ---- the collectives as custom ops: under torch.func.vmap, one call for
# all members --

@torch.library.custom_op("ksfd_tpu_torch::mesh_reduce", mutates_args=())
def _reduce_op(x: torch.Tensor, key: int, op: int) -> torch.Tensor:
    return _reduce_any(x, _OPS[op], _MESHES[key])


@_reduce_op.register_vmap
def _reduce_vmap(info, in_dims, x, key, op):
    # elementwise over the ranks: the member axis may lie anywhere
    return _reduce_any(x, _OPS[op], _MESHES[key]), in_dims[0]


@torch.library.custom_op("ksfd_tpu_torch::mesh_pad", mutates_args=())
def _pad_op(x: torch.Tensor, key: int, width: int) -> torch.Tensor:
    return _pad(x, _MESHES[key], width)


@_pad_op.register_vmap
def _pad_vmap(info, in_dims, x, key, width):
    # the members lead
    return _pad(x.movedim(in_dims[0], 0).contiguous(), _MESHES[key],
                width), 0


@torch.library.custom_op("ksfd_tpu_torch::mesh_gather", mutates_args=())
def _gather_op(x: torch.Tensor, key: int) -> torch.Tensor:
    return _gather(x, _MESHES[key])


@_gather_op.register_vmap
def _gather_vmap(info, in_dims, x, key):
    return _gather(x.movedim(in_dims[0], 0).contiguous(), _MESHES[key]), 0


def all_reduce_sum(x, mesh):
    """The sum of ``x`` over the mesh's ranks (a new tensor)."""
    return _all_reduce(x, 0, mesh)


def all_reduce_max(x, mesh):
    """The elementwise maximum over the ranks (a new tensor)."""
    return _all_reduce(x, 1, mesh)


def all_reduce_min(x, mesh):
    """The elementwise minimum over the ranks (a new tensor)."""
    return _all_reduce(x, 2, mesh)
