"""The device an entry point of the port runs on.

The port runs on the card: an entry point that is not told a device
(``device=None``) takes ``cuda``, and on a machine without a CUDA card
it raises instead of carrying on on the CPU.  A CPU run names
``device="cpu"`` (the CPU tests do).
"""

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``torch.device(device)``, or the card when ``device`` is None.

    Raises RuntimeError for ``None`` when torch sees no CUDA card.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ksfd_tpu_torch runs on a CUDA card by default and this "
            "machine has none; pass device='cpu' to run on the CPU"
        )
    return torch.device("cuda")
