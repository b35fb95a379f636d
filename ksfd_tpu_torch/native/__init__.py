"""Native (host C++) components.  Counterpart: ksfd_tpu/native/."""

from .banded import CyclicBandedSolver, band_storage_from_dense, native_available

__all__ = ["CyclicBandedSolver", "band_storage_from_dense", "native_available"]
