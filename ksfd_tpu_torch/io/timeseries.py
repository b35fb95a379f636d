"""HDF5 time series of solution snapshots.

Counterpart: ksfd_tpu/io/timeseries.py (the reference's
KSFD/ksfdtimeseries.py file format), the same layout so that each
package reads the other's files:

- file names '{name}s{size}r{rank}.h5' (one process writes s1r0; a
  reader also takes any s<size>r<rank> file and the legacy
  '{name}MPI.h5');
- datasets 'data<k>' with attributes k and t, the index datasets
  times/ks/order/lastk;
- '/info' for the problem description, '/grid/*' so that a reader
  rebuilds the Grid without the options file;
- '/solver_state' (t, dt, lastvart, k) for a resume that continues the
  run, and '/info/dt', '/info/lastvart' where the reference's reader
  looks;
- the virtual slab view: a single reader pointed at a complete
  multi-rank slab set opens it as one global series.

Where the port differs:

- h5py is imported on first use, so the package imports on a machine
  without it; opening a series there raises KSFDException naming h5py.
- The noise generator's state is '/solver_state/rng_state' (the uint8
  ``torch.Generator`` state); the reference's JAX key 'rng_key' is not
  read (JAX's draws cannot be continued here) and not written.
- The virtual slab view engages only for mode 'r' (the reference's
  test ``mode[0] == 'r'`` also engages it for 'r+', where a write would
  go through the view into one rank's slab file), and a slab set whose
  ranges do not tile the grid exactly, or whose field count differs,
  is refused instead of assembled into an array with unwritten parts.
"""

import gc
import glob
import os
import re
import time
import traceback

import numpy as np
import torch

from ..grid import Grid
from ..utils.debug import logger
from ..utils.exceptions import KSFDException

logSERIES = logger("SERIES")

__all__ = ["TimeSeries", "Gatherer", "parse_filename", "h5py_module"]

_GRID_ATTRS = [
    "dim",
    "dof",
    "nps",
    "bounds",
    "spacing",
    "order",
    "stencil_width",
]


def h5py_module():
    """``h5py``, imported on first use; KSFDException where it is not
    installed."""
    try:
        import h5py
    except ImportError as e:
        raise KSFDException(
            "HDF5 series need the h5py package, which this Python does "
            "not have (%s); run without --save/--check/--resume/--restart"
            % e
        ) from None
    return h5py


def parse_filename(filename):
    """'bases2r1.h5' -> ('base', 2, 1, False); '...MPI.h5' -> the MPI
    form.  Counterpart: ksfd_tpu/io/timeseries.py:parse_filename."""
    res = re.fullmatch(r"(.*)MPI\.h5", filename)
    if res:
        return (res[1], 1, 0, True)
    res = re.fullmatch(r"(.*)s(\d+)r(\d+)\.h5", filename)
    if res:
        return (res[1], int(res[2]), int(res[3]), False)
    raise ValueError("Couldn't parse filename {f}".format(f=filename))


def _ranges_of(h):
    """The slab ranges a file stores ('ranges', or the reference
    format's '/grid/ranges'), or None."""
    for key in ("ranges", "grid/ranges"):
        if key in h:
            return tuple(tuple(int(x) for x in r)
                         for r in np.asarray(h[key][()]))
    return None


class TimeSeries:
    """Snapshot store for states of shape grid.Vshape.  Counterpart:
    ksfd_tpu/io/timeseries.py:TimeSeries."""

    def __init__(
        self,
        basename,
        grid=None,
        mode="r+",
        size=1,
        rank=0,
        retries=0,
        retry_interval=60,
        mpiok=False,
        ranges=None,
    ):
        """Open or create a time series.

        basename: filename prefix (directories are created as needed).
        grid: required when creating; read from '/grid' otherwise.
        mode: h5py file mode ('r', 'r+', 'w', 'a').
        retries/retry_interval: the open-retry loop for flaky
            filesystems.
        size/rank/mpiok: the filename protocol's rank count and rank.
        ranges: ((lo, hi), ...) per spatial axis: a slab file holding
            that block of the global grid ('/ranges' is written, and
            snapshots have the block's shape).
        """
        self._h5py = h5py_module()
        self.basename = basename
        self._size = size
        self._rank = rank
        self._mode = mode
        self.ranges = tuple(tuple(int(x) for x in r) for r in ranges) \
            if ranges is not None else None
        self.retries = retries
        self.retry_interval = retry_interval
        self.filename = self._get_filename(basename, size, rank, mode)
        if self.creating:
            dirname = os.path.dirname(os.path.abspath(self.filename))
            os.makedirs(dirname, exist_ok=True)
        self._tsf = self.open_with_retry()
        _ = self.info  # ensure /info exists
        if "times" in self.tsf:
            self.ts = np.array(self.tsf["times"][()])
            try:
                self.ks = np.array(self.tsf["ks"][()])
            except KeyError:
                self.ks = np.arange(len(self.ts))
            self.order = np.array(self.tsf["order"][()])
        else:
            self.ts = np.array([], dtype=float)
            self.ks = np.array([], dtype=int)
            self.order = np.array([], dtype=int)
        self.lastk = int(self.ks.max()) if self.ks.size else -1
        self.sorted = False
        if grid is not None:
            self.set_grid(grid)
            if self.mode != "r":
                self.grid_save()
        else:
            self.grid_load()
        if self.ranges is not None and self.mode != "r":
            self.try_to_set("ranges", np.asarray(self.ranges, dtype=np.int64))
        elif self.ranges is None:
            self.ranges = _ranges_of(self.tsf)
        self._slabs = None
        if self._slab_files:
            self._open_slabs()
        self.tsf.flush()

    @property
    def local_shape(self):
        """Shape of one stored snapshot: the slab block, or grid.Vshape."""
        if self.ranges is None:
            return self.grid.Vshape
        return (self.grid.dof,) + tuple(hi - lo for lo, hi in self.ranges)

    # -- the virtual slab view ------------------------------------------
    def _open_slabs(self):
        """Open every file of the slab set; the series then presents the
        global grid (self.ranges -> None) and retrieve_by_number
        assembles snapshots across the slabs.  A set whose ranges do not
        tile the grid exactly, or whose field count is not the grid's,
        raises KSFDException."""
        slabs = []
        for f in self._slab_files:
            h = self.open_with_retry(fname=f, mode="r")
            rng = _ranges_of(h)
            if rng is None:
                # a rangeless member: the set is not a slab
                # decomposition after all; plain reads
                for hh, _ in slabs:
                    hh.close()
                h.close()
                self._slab_files = None
                return
            slabs.append((h, rng))
        try:
            self._check_tiling(slabs)
        except KSFDException:
            for h, _ in slabs:
                h.close()
            self.tsf.close()
            raise
        self._slabs = slabs
        self.ranges = None
        logSERIES("virtual slab view over", len(slabs), "files:",
                  self._slab_files)

    def _check_tiling(self, slabs):
        grid = self.grid
        cover = np.zeros(grid.Sshape, dtype=np.int32)
        for h, rng in slabs:
            where = "slab file %s" % h.filename
            if "grid/dof" in h and int(h["grid/dof"][()]) != grid.dof:
                raise KSFDException(
                    "%s holds %d fields, the series' grid %d"
                    % (where, int(h["grid/dof"][()]), grid.dof))
            if len(rng) != grid.dim or any(
                    not 0 <= lo < hi <= n
                    for (lo, hi), n in zip(rng, grid.Sshape)):
                raise KSFDException(
                    "%s has ranges %r outside the grid %r"
                    % (where, rng, grid.Sshape))
            cover[tuple(slice(lo, hi) for lo, hi in rng)] += 1
        if not (cover == 1).all():
            raise KSFDException(
                "slab set %s does not tile the grid %r exactly (%d points "
                "uncovered, %d covered twice or more); merge or remove "
                "the stale files"
                % (self._slab_files, grid.Sshape, int((cover == 0).sum()),
                   int((cover > 1).sum())))

    @property
    def virtual(self):
        """True when this reader presents a multi-rank slab set as one
        global series."""
        return bool(self._slabs)

    # -- filename protocol ----------------------------------------------
    def _get_filename(self, basename, size, rank, mode):
        name_self = "{n}s{s}r{r}.h5".format(n=basename, s=size, r=rank)
        name_seq = "{n}s1r0.h5".format(n=basename)
        name_mpi = "{n}MPI.h5".format(n=basename)
        writing = mode[0] in ("w", "x")
        self.creating = writing
        self._slab_files = None
        if writing:
            return name_self
        if os.path.isfile(name_self):
            return name_self
        if mode[0] == "r" or mode == "a":
            for cand in (name_seq, name_mpi):
                if os.path.isfile(cand):
                    return cand
            # the virtual slab view: a single read-only reader pointed
            # at a complete multi-rank slab set
            if size == 1 and mode == "r":
                sets = {}
                for f in sorted(glob.glob(basename + "s*r*.h5")):
                    try:
                        _, fsize, frank, _ = parse_filename(
                            os.path.basename(f))
                    except ValueError:
                        continue
                    sets.setdefault(fsize, {})[frank] = f
                for fsize in sorted(sets, reverse=True):
                    ranks = sets[fsize]
                    if fsize > 1 and sorted(ranks) == list(range(fsize)):
                        self._slab_files = [ranks[r] for r in range(fsize)]
                        return ranks[0]
            # a single s<size>r0 file of another run size is readable
            # when it holds the full grid
            cands = sorted(glob.glob(basename + "s*r0.h5"))
            if cands:
                return cands[0]
        self.creating = mode != "r"
        return name_self

    def open_with_retry(self, fname=None, mode=None):
        fname = fname or self.filename
        mode = mode or self.mode
        try:
            return self._h5py.File(fname, mode=mode)
        except OSError:
            retries_left = self.retries
            if retries_left <= 0:
                raise
            while retries_left > 0:
                logSERIES("open failed, retries left:", retries_left,
                          traceback.format_exc(limit=1))
                time.sleep(self.retry_interval)
                try:
                    return self._h5py.File(fname, mode=mode)
                except OSError:
                    if retries_left <= 1:
                        raise
                retries_left -= 1

    # -- grid self-description --------------------------------------------
    def set_grid(self, grid):
        self._grid = grid

    def grid_save(self):
        g = self.grid
        for k, v in g.state().items():
            self.try_to_set("/grid/" + k, v)
        for a in _GRID_ATTRS:
            self.try_to_set("/grid/" + a, getattr(g, a))

    def grid_load(self):
        if "grid" not in self.tsf:
            raise KSFDException(
                "no /grid group in {f}; pass grid=".format(f=self.filename)
            )
        gg = self.tsf["grid"]
        kwargs = {}
        for k in (
            "dim", "width", "height", "depth", "nx", "ny", "nz", "dof",
            "order", "stencil_width",
        ):
            if k in gg:
                v = gg[k][()]
                kwargs[k] = v.item() if np.isscalar(v) or v.shape == () else v
        # reference-format files store the per-axis sizes as 'nps' and
        # the extents as 'bounds'
        if "nx" not in kwargs and "nps" in gg:
            nps = np.asarray(gg["nps"][()]).ravel()
            for name, i in (("nx", 0), ("ny", 1), ("nz", 2)):
                if i < len(nps):
                    kwargs[name] = int(nps[i])
        if "width" not in kwargs and "bounds" in gg:
            bounds = np.asarray(gg["bounds"][()]).ravel()
            for name, i in (("width", 0), ("height", 1), ("depth", 2)):
                if i < len(bounds):
                    kwargs[name] = float(bounds[i])
        self._grid = Grid(**kwargs)

    # -- plumbing -----------------------------------------------------------
    @property
    def info(self):
        if not getattr(self, "_info", None):
            self._info = self.tsf.require_group("/info")
        return self._info

    @property
    def tsf(self):
        return self._tsf

    @property
    def tsFile(self):
        return getattr(self, "_tsf", None) and bool(self._tsf)

    @property
    def mode(self):
        return self._mode

    @property
    def size(self):
        return self._size

    @property
    def rank(self):
        return self._rank

    @property
    def grid(self):
        return self._grid

    def try_to_set(self, key, val):
        if self.mode == "r":
            return
        try:
            del self.tsf[key]
        except KeyError:
            pass
        try:
            self.tsf[key] = val
        except (ValueError, TypeError):
            pass

    def _sort(self):
        if self.sorted:
            return
        self.try_to_set("times", self.ts)
        self.order = self.ts.argsort()
        self.try_to_set("order", self.order)
        self.sts = np.sort(self.ts)
        self.try_to_set("ks", self.ks)
        self.try_to_set("lastk", self.lastk)
        self.sorted = True

    def flush(self):
        self._sort()
        self.tsf.flush()

    def _close_slabs(self):
        for h, _ in self._slabs or ():
            h.close()
        self._slabs = None

    def temp_close(self):
        """Close, keeping the index; reopen() continues (a crash never
        leaves the file open)."""
        self._sort()
        self._close_slabs()
        self.tsf.close()
        self._tsf = None
        self._info = None

    def reopen(self):
        mode = self.mode if self.mode == "r" else "r+"
        self._tsf = self.open_with_retry(mode=mode)
        if self._slab_files:
            self._open_slabs()

    def close(self):
        if not self.tsFile:
            self.reopen()
        self._sort()
        self._close_slabs()
        self.tsf.close()
        self._tsf = None
        self._info = None
        gc.collect()

    # -- solver state --------------------------------------------------------
    def save_solver_state(self, t, dt, lastvart=None, rng_state=None, k=None):
        """Write '/solver_state' (t, dt, lastvart, k and the noise
        generator's state) and the reference's '/info/dt',
        '/info/lastvart'."""
        self.try_to_set("/solver_state/t", float(t))
        self.try_to_set("/solver_state/dt", float(dt))
        if lastvart is not None:
            self.try_to_set("/solver_state/lastvart", float(lastvart))
        if isinstance(rng_state, torch.Tensor):
            self.try_to_set("/solver_state/rng_state",
                            rng_state.detach().cpu().numpy())
        if k is not None:
            self.try_to_set("/solver_state/k", int(k))
        self.try_to_set("/info/dt", float(dt))
        if lastvart is not None:
            self.try_to_set("/info/lastvart", float(lastvart))

    def load_solver_state(self):
        """What '/solver_state' holds: t, dt, lastvart, k and
        ``rng_state`` (a uint8 tensor); else '/info' dt and lastvart.
        A JAX key ('rng_key', written by the reference) is not read."""
        out = {}
        if "solver_state" in self.tsf:
            ss = self.tsf["solver_state"]
            for k in ("t", "dt", "lastvart", "k"):
                if k in ss:
                    out[k] = ss[k][()].item()
            if "rng_state" in ss:
                out["rng_state"] = torch.from_numpy(
                    np.asarray(ss["rng_state"][()], dtype=np.uint8))
        else:
            if "dt" in self.info:
                out["dt"] = float(self.info["dt"][()])
            if "lastvart" in self.info:
                out["lastvart"] = float(self.info["lastvart"][()])
        return out

    # -- snapshots ------------------------------------------------------------
    def store(self, data, t, k=None):
        vals = np.asarray(data).reshape(self.local_shape)
        if k is None:
            k = self.lastk + 1
        self.lastk = k
        self.ks = np.append(self.ks, k)
        self.ts = np.append(self.ts, t)
        key = "data" + str(k)
        if key in self.tsf:
            dset = self.tsf[key]
        else:
            dset = self.tsf.create_dataset(key, self.local_shape,
                                           dtype=vals.dtype)
        dset[...] = vals
        dset.attrs["k"] = k
        dset.attrs["t"] = t
        self.sorted = False
        self.tsf.flush()

    def store_slice(self, ranges, data, t, tol=1e-7):
        """Write a spatial block into the snapshot nearest time t,
        creating one if no stored time is within tol (the merge tool's
        write)."""
        shape = (self.grid.dof,) + tuple(r[1] - r[0] for r in ranges)
        slc = (slice(None),) + tuple(slice(*r) for r in ranges)
        vals = np.asarray(data).reshape(shape)
        na, nb, ta, tb = self.find_time(t)
        n, tn = (na, ta) if abs(t - ta) <= abs(tb - t) else (nb, tb)
        is_new = self.sts.size == 0 or (
            abs(t - tn) / max(abs(t), abs(tn), 1e-300) > tol
        )
        if is_new:
            k = self.lastk + 1
            self.lastk = k
            self.ks = np.append(self.ks, k)
            self.ts = np.append(self.ts, t)
            dset = self.tsf.create_dataset(
                "data" + str(k), self.grid.Vshape, dtype=vals.dtype
            )
            dset.attrs["k"] = k
            dset.attrs["t"] = t
            self.sorted = False
        else:
            dset = self.tsf["data" + str(n)]
        dset[slc] = vals
        self.tsf.flush()

    def times(self):
        self._sort()
        return self.ts

    def steps(self):
        self._sort()
        return self.ks

    def sorted_times(self):
        self._sort()
        return self.sts

    def sorted_steps(self):
        self._sort()
        return self.order

    def retrieve_by_number(self, k):
        key = "data" + str(k)
        if not self.virtual:
            return np.array(self.tsf[key])
        out = None
        for h, rng in self._slabs:
            if key not in h:
                raise KSFDException("slab file %s has no snapshot %d"
                                    % (h.filename, k))
            vals = np.asarray(h[key])
            want = (self.grid.dof,) + tuple(hi - lo for lo, hi in rng)
            if vals.shape != want:
                raise KSFDException(
                    "slab file %s: snapshot %d has shape %r, its ranges "
                    "want %r" % (h.filename, k, vals.shape, want))
            if out is None:
                # every point is written: _check_tiling proved the cover
                out = np.empty(self.grid.Vshape, dtype=vals.dtype)
            out[(slice(None),) + tuple(slice(*r) for r in rng)] = vals
        return out

    def find_time(self, t):
        """Numbers and times of the snapshots flanking t: (na, nb, ta,
        tb), na == nb when t matches or lies outside the stored range."""
        self._sort()
        if self.sts.size == 0:
            return (0, 0, t - 1.0, t - 1.0)
        if t <= self.sts[0]:
            k = self.ks[self.order[0]]
            return (k, k, self.sts[0], self.sts[0])
        if t >= self.sts[-1]:
            k = self.ks[self.order[-1]]
            return (k, k, self.sts[-1], self.sts[-1])
        b = int(self.sts.searchsorted(t))
        tb = self.sts[b]
        if tb == t:
            return (self.ks[self.order[b]], self.ks[self.order[b]], tb, tb)
        a = b - 1
        return (self.ks[self.order[a]], self.ks[self.order[b]],
                self.sts[a], self.sts[b])

    def retrieve_by_time(self, t):
        """Snapshot at time t, linearly interpolated between stores."""
        na, nb, ta, tb = self.find_time(t)
        adata = self.retrieve_by_number(na)
        if na == nb:
            return adata
        bdata = self.retrieve_by_number(nb)
        return ((t - ta) * bdata + (tb - t) * adata) / (tb - ta)


class Gatherer:
    """Iterate over the per-rank files of one run prefix, each opened
    read-only with its .rank, .size and .ranges (the full grid for a
    rangeless file).  Counterpart: ksfd_tpu/io/timeseries.py:Gatherer."""

    def __init__(self, basename):
        self.basename = basename
        pattern = basename + "s*r*.h5"
        files = sorted(glob.glob(pattern))
        if not files and os.path.isfile(basename + "MPI.h5"):
            files = [basename + "MPI.h5"]
        if not files:
            raise KSFDException("no files match {p}".format(p=pattern))
        self.files = files

    def __iter__(self):
        for f in self.files:
            base, size, rank, _ = parse_filename(os.path.basename(f))
            ts = TimeSeries(os.path.join(os.path.dirname(f), base),
                            mode="r", size=size, rank=rank)
            ts._size, ts._rank = size, rank
            if ts.ranges is None:
                ts.ranges = tuple((0, int(n)) for n in ts.grid.nps)
            yield ts
