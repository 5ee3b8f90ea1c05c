"""A small keyed cache of link objects for the functional entry points.

A link (SisoLink, SimoLink, SfbcLink, SpatialLink) copies its GEMM tables
to the device when it is built: about 55 MB at 20 MHz. `simulate_siso` and
its siblings would pay that on every call, so they ask `cached_link` for the
link of their (class, config, device, branch arguments) and build it only
the first time. The cache is a plain dict of at most `MAX_LINKS` objects,
the least recently used dropped first; the device tensors live in the
links' buffers and go with them.
"""
from __future__ import annotations

from collections import OrderedDict

MAX_LINKS = 8
_links: "OrderedDict[tuple, object]" = OrderedDict()


def cached_link(cls, *args):
    """The link `cls(*args)`, built on first use and kept. Every argument is
    hashable (an LTEConfig, a torch.device, strings and numbers)."""
    key = (cls,) + args
    link = _links.get(key)
    if link is None:
        link = _links[key] = cls(*args)
        while len(_links) > MAX_LINKS:
            _links.popitem(last=False)
    else:
        _links.move_to_end(key)
    return link


def clear_link_cache() -> None:
    """Drop every kept link (and with it its tables on the device)."""
    _links.clear()
