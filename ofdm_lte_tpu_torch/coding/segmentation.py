"""Code block segmentation (TS 36.212 §5.1.2), on the host.

A copy of ofdm_lte_tpu/coding/segmentation.py (NumPy). It keeps that
package's filler-bit placement and per-block bit distribution: the
information bits are spread evenly with the remainder in the last block,
which deviates slightly from the strict spec. It runs in NumPy because the
block sizes K± decide the shapes downstream.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

from .crc import attach_crc24b

Z_MAX = 6144
L_CRC = 24

# Valid turbo interleaver sizes (TS 36.212 Table 5.1.3-3): 40..512 step 8,
# 528..1024 step 16, 1056..2048 step 32, 2112..6144 step 64.
TURBO_INTERLEAVER_SIZES = (
    list(range(40, 512 + 1, 8)) + list(range(528, 1024 + 1, 16))
    + list(range(1056, 2048 + 1, 32)) + list(range(2112, 6144 + 1, 64)))


def find_interleaver_size(min_size: int) -> int:
    for size in TURBO_INTERLEAVER_SIZES:
        if size >= min_size:
            return size
    raise ValueError(f"No valid interleaver size for min_size={min_size}")


def _plan(B: int):
    """(C, K+, K−, C+, C−) of a transport block of B > Z_MAX bits."""
    C = int(np.ceil(B / (Z_MAX - L_CRC)))
    B_prime = B + C * L_CRC
    K_plus = find_interleaver_size(int(np.ceil(B_prime / C)))
    kp_idx = TURBO_INTERLEAVER_SIZES.index(K_plus)
    K_minus = TURBO_INTERLEAVER_SIZES[kp_idx - 1] if kp_idx > 0 else K_plus
    delta = K_plus - K_minus
    C_minus = (C * K_plus - B_prime) // delta if delta > 0 else 0
    return C, K_plus, K_minus, C - C_minus, C_minus


def segment_layout(B: int) -> dict:
    """Shape-only segmentation plan for a transport block of B bits (CRC-24A
    included): everything `segment_code_blocks` decides that does not depend
    on the bit values. Returns {segmented, sizes[C], fillers[C], info[C],
    positions[C]}, positions[r] being the offset of block r's information
    bits within the transport block."""
    if B <= Z_MAX:
        K = find_interleaver_size(B)
        return {"segmented": False, "sizes": [K], "fillers": [K - B],
                "info": [B], "positions": [0]}
    C, K_plus, K_minus, _, C_minus = _plan(B)
    sizes, fillers, info, positions = [], [], [], []
    remaining, pos = B, 0
    for r in range(C):
        K_r = K_minus if r < C_minus else K_plus
        avail = K_r - L_CRC
        take = remaining if r == C - 1 else min(avail, remaining // (C - r))
        sizes.append(K_r)
        fillers.append(avail - take)
        info.append(take)
        positions.append(pos)
        remaining -= take
        pos += take
    return {"segmented": True, "sizes": sizes, "fillers": fillers,
            "info": info, "positions": positions}


def segment_code_blocks(tb_with_crc) -> Tuple[List[np.ndarray], dict]:
    """Transport block (with CRC-24A) -> list of code blocks + metadata."""
    tb = np.asarray(tb_with_crc, np.uint8)
    B = len(tb)
    if B <= Z_MAX:
        K = find_interleaver_size(B)
        F = K - B
        cb = np.zeros(K, np.uint8)
        cb[F:] = tb
        return [cb], {"num_blocks": 1, "block_sizes": [K], "num_filler_bits": F,
                      "filler_per_block": [F], "original_size": B, "segmented": False}

    C, K_plus, K_minus, C_plus, C_minus = _plan(B)
    lay = segment_layout(B)
    blocks = []
    for K_r, F_r, info, pos in zip(lay["sizes"], lay["fillers"], lay["info"],
                                   lay["positions"]):
        body = np.zeros(K_r - L_CRC, np.uint8)
        body[F_r:F_r + info] = tb[pos:pos + info]
        blocks.append(attach_crc24b(body))
    return blocks, {
        "num_blocks": C, "block_sizes": lay["sizes"],
        "num_filler_bits": int(sum(lay["fillers"])), "filler_per_block": lay["fillers"],
        "original_size": B, "segmented": True,
        "K_plus": K_plus, "K_minus": K_minus, "C_plus": C_plus, "C_minus": C_minus,
    }


def desegment_code_blocks(blocks: List[np.ndarray], meta: dict) -> np.ndarray:
    """Inverse: strip each block's CRC-24B (if segmented) and its filler
    bits, concatenate."""
    if not meta["segmented"]:
        return np.asarray(blocks[0], np.uint8)[meta["filler_per_block"][0]:]
    out = [np.asarray(blk, np.uint8)[:-L_CRC][F_r:]
           for blk, F_r in zip(blocks, meta["filler_per_block"])]
    return np.concatenate(out)[:meta["original_size"]]
