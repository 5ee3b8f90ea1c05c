"""Where the package's objects put their tables and run.

The port is written for a CUDA card: an entry point that is given no
device takes the card, and raises where there is none. It never carries
on silently on the CPU; a caller who wants the CPU says so.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card.

    Raises RuntimeError when no device is given and no card is present."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "ofdm_lte_tpu_torch runs on a CUDA card by default and found none "
            '(torch.cuda.is_available() is False); pass device="cpu" to run on the CPU')
    return torch.device("cuda")
