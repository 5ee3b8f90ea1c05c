"""The coding chain's constant tables on a device.

The tables themselves (the CRC matrix, the rate-matching gathers) are
NumPy, made once per shape and cached. A device copy of one is kept here,
in a plain dict of at most `MAX_TABLES` tensors keyed by the table and the
device (device.kept), so that a loop over one transport-block size uploads
each table once.
"""
from __future__ import annotations

from collections import OrderedDict

import numpy as np
import torch

from ..device import kept

MAX_TABLES = 16
_tables: "OrderedDict[tuple, torch.Tensor]" = OrderedDict()


def on_device(key: tuple, make, device) -> torch.Tensor:
    """The tensor of NumPy `make()` on `device`, kept under `key`."""
    return kept(_tables, MAX_TABLES, key,
                lambda dev: torch.as_tensor(np.ascontiguousarray(make()), device=dev), device)
