"""Where the package's objects put their tables and run.

The port is written for a CUDA card: an entry point that is given no
device takes the card, and raises where there is none. It never carries
on silently on the CPU; a caller who wants the CPU says so.
"""
from __future__ import annotations

from collections import OrderedDict

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


def kept(store: "OrderedDict[tuple, object]", limit: int, key: tuple, make, device):
    """`make(device)`, made on first use for (key, device) and kept in
    `store`, a plain dict of at most `limit` entries, the least recently
    used dropped first. The constant tables that belong to no link object
    live in such stores, one per module, keyed by their device too."""
    device = torch.empty(0, device=device).device      # "cuda" and "cuda:0" are one key
    key = key + (device,)
    value = store.get(key)
    if value is None:
        value = store[key] = make(device)
        while len(store) > limit:
            store.popitem(last=False)
    else:
        store.move_to_end(key)
    return value
