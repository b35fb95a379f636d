"""Solver monitors that persist state: the saved series and checkpoints.

Counterpart: ksfd_tpu/io/monitors.py (the reference's makeSaveMonitor
and checkpointMonitor, KSFD/ksfdts.py:370-497).  Both store the pickled
problem description in '/info' (``picklenp``) with dt and lastvart;
checkpoints also carry '/solver_state' (the step counter and the noise
generator's state) so that a resumed run continues the interrupted one.
"""

import os
import pickle
import zipfile

import numpy as np
import torch

from ..utils.debug import logger
from ..utils.exceptions import KSFDException
from .timeseries import TimeSeries

logSERIES = logger("SERIES")

__all__ = [
    "picklenp",
    "pickleunp",
    "make_save_monitor",
    "make_checkpoint_monitor",
    "write_info",
    "snapshot_block",
]


def picklenp(obj):
    """An object pickled into a uint8 array (storable in HDF5).
    Counterpart: ksfd_tpu/io/monitors.py:picklenp."""
    return np.frombuffer(pickle.dumps(obj), dtype=np.uint8)


def pickleunp(arr):
    """Counterpart: ksfd_tpu/io/monitors.py:pickleunp.  Unpickles what
    ``picklenp`` stored: open only series this program wrote."""
    return pickle.loads(np.asarray(arr).tobytes())


def snapshot_block(u, ranges):
    """The block of state ``u`` that a TimeSeries stores, as numpy: the
    whole state for ``ranges`` None; for a slab series (``ranges``, a
    ``(lo, hi)`` per spatial axis) ``u`` itself when it is that block (a
    rank's slab on a mesh), else that block of the global ``u``.
    Counterpart: ksfd_tpu/io/monitors.py:snapshot_block.  A ``u`` that
    is neither raises KSFDException."""
    if ranges is not None:
        block = tuple(int(hi) - int(lo) for lo, hi in ranges)
        if tuple(u.shape[1:]) != block:
            if len(ranges) != len(u.shape) - 1 or any(
                    not 0 <= int(lo) < int(hi) <= n
                    for (lo, hi), n in zip(ranges, u.shape[1:])):
                raise KSFDException(
                    "state of shape %s holds neither the block %r nor a "
                    "grid containing it" % (tuple(u.shape), tuple(ranges)))
            u = u[(slice(None),) + tuple(slice(int(lo), int(hi))
                                         for lo, hi in ranges)]
    if isinstance(u, torch.Tensor):
        return u.detach().cpu().numpy()
    return np.asarray(u)


def write_info(tseries, clargs=None, ps=None, sources=None):
    """Store the problem description in /info under the reference's
    names.  Counterpart: ksfd_tpu/io/monitors.py:write_info."""
    if clargs is not None:
        tseries.try_to_set("/info/commandlineArguments", picklenp(clargs))
    if ps is not None:
        tseries.try_to_set("/info/SolutionParameters", picklenp(ps))
    if sources is not None:
        tseries.try_to_set("/info/sources", picklenp(sources))


def make_save_monitor(tseries, every=1):
    """(monitor, closer) writing accepted steps into ``tseries``.
    Counterpart: ksfd_tpu/io/monitors.py:make_save_monitor.

    The file is reopened and temp-closed around every write, so an
    abort never leaves it corrupt.  every: the least step spacing
    between snapshots (1: every accepted step).  The driver forces a
    final write (``force=True``) after the loop; writes are
    deduplicated by k, so the forced call never repeats a snapshot.
    """
    every = max(1, int(every))
    last_saved = {"k": None}

    def save_monitor(solver, k, t, u, force=False):
        if last_saved["k"] == k:
            return
        if (not force and last_saved["k"] is not None
                and k - last_saved["k"] < every):
            return
        if not tseries.tsFile:
            tseries.reopen()
        tseries.store(snapshot_block(u, tseries.ranges), t, k=k)
        tseries.save_solver_state(t=t, dt=solver.h, lastvart=solver.lastvart,
                                  rng_state=solver.rng_state, k=k)
        tseries.temp_close()
        # marked only after the write lands: a failed store must not
        # block the forced final save of the same k
        last_saved["k"] = k

    def close_save_monitor():
        pass  # the creator owns the TimeSeries

    return save_monitor, close_save_monitor


def make_checkpoint_monitor(prefix, grid, clargs=None, ps=None, sources=None,
                            retries=0, retry_interval=60,
                            size=1, rank=0, ranges=None):
    """Monitor writing a one-snapshot TimeSeries '<prefix>_<k>_' per
    step.  Counterpart: ksfd_tpu/io/monitors.py:make_checkpoint_monitor.

    If ``prefix`` ends with '.zip' each checkpoint file is appended to
    the archive '<prefix>s<size>r<rank>.zip' and removed.
    """
    zipit = prefix.endswith(".zip")
    realpfx = prefix[:-4] if zipit else prefix

    def checkpoint_monitor(solver, k, t, u):
        cpf = TimeSeries(
            realpfx + "_" + str(k) + "_", grid=grid, mode="w",
            retries=retries, retry_interval=retry_interval,
            size=size, rank=rank, ranges=ranges,
        )
        write_info(cpf, clargs=clargs, ps=ps, sources=sources)
        cpf.save_solver_state(t=t, dt=solver.h, lastvart=solver.lastvart,
                              rng_state=solver.rng_state, k=k)
        cpf.store(snapshot_block(u, ranges), t, k=k)
        cpfname = cpf.filename
        cpf.close()
        if zipit:
            zfname = "{p}s{s}r{r}.zip".format(p=realpfx, s=size, r=rank)
            zfmode = "w" if k == 0 else "a"
            try:
                zf = zipfile.ZipFile(zfname, mode=zfmode,
                                     compression=zipfile.ZIP_DEFLATED)
            except RuntimeError:  # no zlib
                zf = zipfile.ZipFile(zfname, mode=zfmode,
                                     compression=zipfile.ZIP_STORED)
            with zf:
                zf.write(cpfname, arcname=os.path.basename(cpfname))
            os.remove(cpfname)

    return checkpoint_monitor
