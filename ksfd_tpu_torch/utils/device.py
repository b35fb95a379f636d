"""The device an entry point of the port runs on.

The port runs on the card: an entry point that is not told a device
(``device=None``) takes ``cuda``, and on a machine without a CUDA card
it raises instead of carrying on on the CPU.  A CPU run names
``device="cpu"`` (the CPU tests do).
"""

import subprocess

import torch

__all__ = ["resolve_device", "card_line"]


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


def card_line():
    """The card's ``name, power.limit`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` reports them
    (the first card), the label every measurement carries."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    return out[0]
