"""The work arithmetic of the kernels that the per-layer metrics bound.

One count a kernel's work, whatever form or precision implements it, so
that a change of kernel never changes the yardstick and no share can pass
100%:

- a complex product (m, k) @ (k, n): 6·m·k·n real flops (three real
  products, the least any form computes), A and B read once and C written
  once as fp32 re/im planes (8 B a complex element); its least time is the
  larger of flops at the bf16 dense rate (the card's highest for 16-bit or
  wider inputs) and bytes at the HBM rate;
- a max-log BCJR trellis step of one code block in an extrinsic pass of the
  turbo decoder: 109 fp32 operations (4 branch metrics of 3, α and β of
  16 adds and 8 ⊕ each, the APP's 32 adds, 2 × 7 ⊕ and a subtraction, two
  subtractions for the extrinsic) and 16 B (3 LLRs in, 1 out); its least
  time the larger of the operations at the fp32 rate and the bytes at the
  HBM rate. The counts are ofdm_lte_tpu_torch/utils/profiling's
  BCJR_OPS_PER_STEP["extrinsic"] and BCJR_BYTES_PER_STEP, copied.
"""
from __future__ import annotations

from .peaks import H100_SXM


def cgemm_flops(m: int, k: int, n: int) -> float:
    return 6.0 * m * k * n


def cgemm_bytes(m: int, k: int, n: int) -> float:
    return 8.0 * (m * k + k * n + m * n)


def cgemm_bound_s(m: int, k: int, n: int, peaks=H100_SXM) -> float:
    """The least time one complex product of these sizes can take."""
    return max(cgemm_flops(m, k, n) / peaks["bf16_dense_flops"],
               cgemm_bytes(m, k, n) / peaks["hbm_bytes_per_s"])


def siso_products(lanes: int, symbols: int, n_fft: int, cp: int, n_data: int,
                  n_pilot: int, slot: int = 14, jakes_taps: int = 0,
                  sinusoids: int = 16) -> list:
    """(name, m, k, n) of the complex products one SISO link step makes over
    `lanes` frames: the TX grid-IDFT-CP product, the RX DFTs to the data
    bins and to the slot-start symbols' pilot bins, and, over Jakes
    multipath, the tap product P (lanes·taps, 16) @ E (16, samples)."""
    slots = -(-symbols // slot)
    out = [("tx", lanes * symbols, n_data, n_fft + cp),
           ("rx_data", lanes * symbols, n_fft, n_data),
           ("rx_pilot", lanes * slots, n_fft, n_pilot)]
    if jakes_taps:
        out.append(("jakes", lanes * jakes_taps, sinusoids, symbols * (n_fft + cp)))
    return out


BCJR_OPS_PER_STEP = 109
BCJR_BYTES_PER_STEP = 16


def bcjr_bound_s(steps: float, peaks=H100_SXM) -> float:
    """The least time of `steps` trellis steps of extrinsic BCJR passes."""
    return steps * max(BCJR_OPS_PER_STEP / peaks["fp32_flops"],
                       BCJR_BYTES_PER_STEP / peaks["hbm_bytes_per_s"])


def harq_bcjr_steps(transmissions: int, block_sizes, num_iterations: int) -> int:
    """The trellis steps of the BCJR passes that `transmissions` decodes
    need: a decode of a transport block is 2·num_iterations passes over
    each code block's K + 3 steps (the final hard-decision pass is not
    counted)."""
    return int(transmissions) * 2 * int(num_iterations) * sum(int(K) + 3 for K in block_sizes)
