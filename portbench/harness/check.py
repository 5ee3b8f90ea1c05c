"""The comparison that decides `correct`: a sampled call's sweep results
against the reference's for the same inputs.

Each entry's adapter (entries/<entry>.py) compares its own results; the
numbers that decide are the keys of `limits/<cell>.json`, each the worst
over the calls checked, and a key that the adapter does not produce fails
the call. `compare` is `ber_sweep`'s:

- `error_gap_bits`: Σ over the SNR points of |errors(port) − errors(ref)|,
  the bit decisions that differ in count. The float64 reference and the
  port's float32 arithmetic part on decisions that lie within rounding of
  a boundary; a lower precision parts on many more;
- `papr_gap_db`: the largest |PAPR(port) − PAPR(ref)| of a point's mean,
  which holds the TX product to its precision;
- `bits_gap`: Σ |total bits(port) − total bits(ref)|, exact.

Each limit comes from `limits/<cell>.json`.
"""
from __future__ import annotations

import numpy as np

def compare(port: dict, ref: dict) -> dict:
    e_p, e_r = np.asarray(port["bit_errors"], np.int64), np.asarray(ref["bit_errors"], np.int64)
    t_p, t_r = np.asarray(port["total_bits"], np.int64), np.asarray(ref["total_bits"], np.int64)
    if e_p.shape != e_r.shape or t_p.shape != t_r.shape:
        return {"error_gap_bits": float("inf"), "papr_gap_db": float("inf"),
                "bits_gap": float("inf")}
    papr = np.abs(np.asarray(port["papr_db"], np.float64) - np.asarray(ref["papr_db"]))
    return {"error_gap_bits": float(np.abs(e_p - e_r).sum()),
            "papr_gap_db": float(papr.max()) if np.all(np.isfinite(papr)) else float("inf"),
            "bits_gap": float(np.abs(t_p - t_r).sum())}


def worst(readings: list, keys=None) -> dict:
    """The worst of each number over the calls checked (every number the
    readings hold, or `keys`, a missing one reading inf)."""
    if not readings:
        return {}
    keys = list(readings[0]) if keys is None else list(keys)
    return {k: max(r.get(k, float("inf")) for r in readings) for k in keys}


def verdict(readings: list, limits: dict):
    """(correct, calls over a limit, {number: {value, limit}}) over the
    numbers that `limits` names."""
    w = worst(readings, limits)
    failed = sum(any(r.get(k, float("inf")) > lim for k, lim in limits.items())
                 for r in readings)
    checks = {k: {"value": w[k], "limit": limits[k]} for k in limits} if w else {}
    return bool(readings) and failed == 0, failed, checks
