"""OFDM modulation/demodulation as complex GEMMs against DFT submatrices.

Port of ofdm_lte_tpu/ops/ofdm.py. The grid scatter, IDFT·√N and cyclic
prefix fuse into one complex GEMM plus a constant pilot waveform,

    tx[s, t] = Σ_d  data[s, d] · B[d, t]  +  pilot_wave[t],

with t over the CP-extended time axis and d over the data bins only; the
receiver computes only the bins it needs,

    bins[s, k] = Σ_t  y[s, cp + t] · G[t, k],   G = exp(-2πi·k·t/N)/√N.

The SFBC and spatial TX paths use the same GEMM over a custom bin layout
(`modulate_custom`, `modulate_custom_multi`), and `modulate_grid` runs the
IDFT of an explicit N-bin grid. Every GEMM goes through `_cmm`, which
sends a CUDA tensor to the hand-written kernel and a CPU tensor to its
plain version (ops/cmatmul.py). The leading batch dimensions are always
flattened into the GEMM's M dimension.

The DFT tables are built and cached as NumPy (`_mod_consts`,
`_demod_consts`); tensors on a device live in a module's buffers
(sim.siso.SisoLink), which pass them in as `tables`. Without `tables`
the functions copy the cached NumPy tables to the input's device.
"""
from __future__ import annotations

import functools
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..cplx import C
from ..config import LTEConfig
from ..grid import make_grid, pilot_sequence
from .cmatmul import cmatmul

_CMATMUL_FORMS = ("fma4", "gauss")


def _cmm(a: C, b: C) -> C:
    """Complex matmul for the modem, a (..., K) @ b (K, N).

    The form follows OFDM_LTE_TPU_TORCH_CMATMUL ∈ {fma4, gauss}, default
    `fma4`: the 4-multiply, float-faithful form. `gauss` is the 3-multiply
    form (−25% FLOPs, one extra rounding in the imaginary part)."""
    form = os.environ.get("OFDM_LTE_TPU_TORCH_CMATMUL", "fma4").lower()
    if form not in _CMATMUL_FORMS:
        raise ValueError(f"OFDM_LTE_TPU_TORCH_CMATMUL={form!r}; pick from {_CMATMUL_FORMS}")
    return cmatmul(a, b, gauss=(form == "gauss"))


@functools.lru_cache(maxsize=None)
def grid_for_cached(N: int, Nc: int):
    return make_grid(N, Nc)


@functools.lru_cache(maxsize=None)
def _mod_consts(N: int, Nc: int, cp: int, cell_id: int):
    """(B_re, B_im) of shape (n_data, N+cp) and pilot_wave (N+cp,), float32."""
    g = grid_for_cached(N, Nc)
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])       # (N+cp,)
    k_data = g.data_idx.astype(np.float64)
    A = np.exp(2j * np.pi * np.outer(t, k_data) / N) / np.sqrt(N)  # (N+cp, n_data)

    pilots = pilot_sequence(cell_id, g.num_pilot)
    k_pil = g.pilot_idx.astype(np.float64)
    Ap = np.exp(2j * np.pi * np.outer(t, k_pil) / N) / np.sqrt(N)
    pilot_wave = Ap @ pilots                                        # (N+cp,)

    B = A.T                                                         # (n_data, N+cp)
    return (B.real.astype(np.float32), B.imag.astype(np.float32),
            pilot_wave.real.astype(np.float32),
            pilot_wave.imag.astype(np.float32))


@functools.lru_cache(maxsize=None)
def _demod_consts(N: int, cp: int, bins: tuple):
    """(G_re, G_im) of shape (N, n_bins): time -> selected frequency bins."""
    t = np.arange(N)
    k = np.asarray(bins, np.float64)
    G = np.exp(-2j * np.pi * np.outer(t, k) / N) / np.sqrt(N)       # (N, n_bins)
    return G.real.astype(np.float32), G.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _mod_consts_custom(N: int, cp: int, data_bins: tuple, pilot_bins: tuple, cell_id: int):
    """_mod_consts for an arbitrary static bin layout: each antenna of the
    SFBC and spatial TX paths maps data to a subset of the bins and carries
    its own orthogonal CRS pilots. No pilot bins give a zero pilot wave."""
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])
    k_data = np.asarray(data_bins, np.float64)
    A = np.exp(2j * np.pi * np.outer(t, k_data) / N) / np.sqrt(N)
    if len(pilot_bins):
        pw_re, pw_im = _pilot_wave_const(N, cp, pilot_bins, cell_id)
    else:
        pw_re = pw_im = np.zeros(len(t), np.float32)
    B = A.T
    return B.real.astype(np.float32), B.imag.astype(np.float32), pw_re, pw_im


@functools.lru_cache(maxsize=None)
def _pilot_wave_const(N: int, cp: int, pilot_bins: tuple, cell_id: int):
    """Constant time-domain CRS contribution of one antenna's pilot layout:
    pw[t] = Σ_j p_j·exp(2πi·t·k_j/N)/√N over the CP-extended time axis."""
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])
    pilots = pilot_sequence(cell_id, len(pilot_bins))
    Ap = np.exp(2j * np.pi * np.outer(t, np.asarray(pilot_bins, np.float64)) / N) / np.sqrt(N)
    pw = Ap @ pilots
    return pw.real.astype(np.float32), pw.imag.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _full_idft_consts(N: int, cp: int):
    """(F_re, F_im) of shape (N, N+cp): every bin -> CP-extended time."""
    t = np.concatenate([np.arange(N - cp, N), np.arange(N)])
    k = np.arange(N, dtype=np.float64)
    A = np.exp(2j * np.pi * np.outer(k, t) / N) / np.sqrt(N)
    return A.real.astype(np.float32), A.imag.astype(np.float32)


class ModTables(NamedTuple):
    """Device tables of modulate_symbols: B and the pilot wave."""
    b: C
    pilot_wave: C


def _planes(re: np.ndarray, im: np.ndarray, device) -> C:
    """Row-major copies of two cached NumPy planes on `device` (the GEMM
    kernel needs unit inner stride; _mod_consts' B is a transposed view)."""
    return C(torch.tensor(np.ascontiguousarray(re), device=device),
             torch.tensor(np.ascontiguousarray(im), device=device))


def mod_tables(config: LTEConfig, cell_id: int = 0, device=None) -> ModTables:
    Bre, Bim, pw_re, pw_im = _mod_consts(config.N, config.Nc, config.cp_length, cell_id)
    return ModTables(_planes(Bre, Bim, device), _planes(pw_re, pw_im, device))


def demod_tables(config: LTEConfig, bins, device=None) -> C:
    """G of demodulate_bins on `device`."""
    return _planes(*_demod_consts(config.N, config.cp_length, _int_tuple(bins)), device)


def _int_tuple(bins) -> tuple:
    return tuple(int(b) for b in bins)


def mod_tables_custom(config: LTEConfig, data_bins, pilot_bins, cell_id: int,
                      device=None) -> ModTables:
    Bre, Bim, pw_re, pw_im = _mod_consts_custom(
        config.N, config.cp_length, _int_tuple(data_bins), _int_tuple(pilot_bins), cell_id)
    return ModTables(_planes(Bre, Bim, device), _planes(pw_re, pw_im, device))


def mod_tables_multi(config: LTEConfig, data_bins, pilot_bins_per_tx, cell_ids,
                     device=None) -> ModTables:
    """One B for the shared data bins and a (tx, N+cp) pilot wave."""
    b = mod_tables_custom(config, data_bins, (), 0, device)
    pw = [_pilot_wave_const(config.N, config.cp_length, _int_tuple(p), int(c))
          for p, c in zip(pilot_bins_per_tx, cell_ids)]
    return ModTables(b.b, _planes(np.stack([w[0] for w in pw]),
                                  np.stack([w[1] for w in pw]), device))


def idft_tables(config: LTEConfig, device=None) -> C:
    """F of modulate_grid on `device`."""
    return _planes(*_full_idft_consts(config.N, config.cp_length), device)


def modulate_symbols(data: C, config: LTEConfig, cell_id: int = 0,
                     tables: Optional[ModTables] = None) -> C:
    """Map data symbols onto the LTE grid and produce CP-prefixed time signals.

    data: C (..., S, n_data) -> C (..., S, N+cp). One complex GEMM.
    """
    if tables is None:
        tables = mod_tables(config, cell_id, data.re.device)
    out = _cmm(data, tables.b)
    return C(out.re + tables.pilot_wave.re, out.im + tables.pilot_wave.im)


def modulate_custom(data: C, config: LTEConfig, data_bins, pilot_bins, cell_id: int,
                    tables: Optional[ModTables] = None) -> C:
    """Grid scatter + IDFT + CP for a custom data/pilot bin layout.

    data: C (..., S, len(data_bins)) -> C (..., S, N+cp). One complex GEMM."""
    if tables is None:
        tables = mod_tables_custom(config, data_bins, pilot_bins, cell_id, data.re.device)
    out = _cmm(data, tables.b)
    return C(out.re + tables.pilot_wave.re, out.im + tables.pilot_wave.im)


def modulate_custom_multi(data: C, config: LTEConfig, data_bins, pilot_bins_per_tx,
                          cell_ids, tables: Optional[ModTables] = None) -> C:
    """The same for num_tx antennas that share one data-bin layout and carry
    per-TX orthogonal CRS: the DFT submatrix depends only on the shared data
    bins, so all antennas go through one GEMM with the antenna axis folded
    into M, plus a per-TX constant pilot wave.

    data: C (tx, ..., S, m) with the antenna axis leading -> C (tx, ..., S,
    N+cp): each antenna's symbols lie end to end, so its sample stream is a
    view of the result."""
    if tables is None:
        tables = mod_tables_multi(config, data_bins, pilot_bins_per_tx, cell_ids,
                                  data.re.device)
    out = _cmm(data, tables.b)
    pw = tables.pilot_wave.reshape((data.shape[0],) + (1,) * (out.ndim - 2) + (-1,))
    return C(out.re + pw.re, out.im + pw.im)


def modulate_grid(grid: C, config: LTEConfig, tables: Optional[C] = None) -> C:
    """IDFT·√N + CP of an explicit full N-bin grid (..., S, N) -> (..., S, N+cp)."""
    if tables is None:
        tables = idft_tables(config, grid.re.device)
    return _cmm(grid, tables)


def demodulate_bins(y: C, config: LTEConfig, bins,
                    tables: Optional[C] = None) -> C:
    """CP strip + DFT/√N restricted to `bins`.

    y: C (..., S, N+cp) time-domain symbols -> C (..., S, len(bins)). The
    CP-stripped operand is a strided view that the GEMM reads in place.
    """
    ysig = y[..., config.cp_length:]
    if tables is None:
        tables = demod_tables(config, bins, y.re.device)
    return _cmm(ysig, tables)


def demodulate_full(y: C, config: LTEConfig, tables: Optional[C] = None) -> C:
    """CP strip + full-N DFT/√N: (..., S, N+cp) -> (..., S, N)."""
    return demodulate_bins(y, config, np.arange(config.N), tables)


def frame_stream(signal: C, config: LTEConfig) -> C:
    """Chunk a flat sample stream (..., S·(N+cp)) into (..., S, N+cp) symbols
    (trailing partial symbols are dropped)."""
    sps = config.samples_per_ofdm_symbol
    S = signal.shape[-1] // sps
    lead = tuple(signal.shape[:-1])
    return C(signal.re[..., :S * sps].reshape(lead + (S, sps)),
             signal.im[..., :S * sps].reshape(lead + (S, sps)))


def papr_per_symbol_db(signal: C, config: LTEConfig, include_cp: bool = True) -> torch.Tensor:
    """Per-OFDM-symbol PAPR, optionally without the cyclic prefix.

    signal: (..., S·(N+cp)) -> (..., S)."""
    framed = frame_stream(signal, config)
    if not include_cp:
        framed = framed[..., config.cp_length:]
    return papr_db(framed, axis=-1)


def papr_db(signal: C, axis=None) -> torch.Tensor:
    """Peak-to-average power ratio in dB."""
    p = signal.abs2()
    if axis is None:
        peak, mean = p.max(), p.mean()
    else:
        peak, mean = p.amax(dim=axis), p.mean(dim=axis)
    return 10.0 * torch.log10(peak / mean)
