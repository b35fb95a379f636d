"""HDF5 I/O: the time series, its monitors and the run reader.

Counterpart: ksfd_tpu/io/.  h5py is imported on first use
(timeseries.py:h5py_module), so this package imports without it.
"""

from .timeseries import TimeSeries, Gatherer, parse_filename, h5py_module
from .solution import Solution
from .monitors import (
    picklenp,
    pickleunp,
    make_save_monitor,
    make_checkpoint_monitor,
    write_info,
    snapshot_block,
)

__all__ = [
    "TimeSeries",
    "Gatherer",
    "parse_filename",
    "h5py_module",
    "Solution",
    "picklenp",
    "pickleunp",
    "make_save_monitor",
    "make_checkpoint_monitor",
    "write_info",
    "snapshot_block",
]
