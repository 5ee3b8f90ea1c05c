"""Rayleigh fading channels: Jakes sum-of-sinusoids + ITU multipath FIR.

Port of ofdm_lte_tpu/channel/rayleigh.py:

- Jakes fading h(t) = √(2/Ns)·Σ_n exp(j(2π f_D cos(α_n) t + φ_n)) with
  Ns = 16 sinusoids, α_n = 2πn/Ns, φ_n ~ U(0, 2π), as ONE complex GEMM
      H (L, T) = P (L, Ns) @ E (Ns, T)
  where E = exp(j ω_n t) is shared by all links and taps and P = exp(j φ)
  carries the per-(lane, tap, link) random phases. The product goes through
  `ops.ofdm._cmm`: the hand-written kernel on a CUDA tensor (K = 16, less
  than one K slab, masked), its plain version on a CPU tensor. Its output
  (8·L·T bytes) is what bounds it.

- Multipath: y(t) = Σ_i g_i · h_i(t) · x(t − d_i) with integer-sample static
  delays d_i = round(delay·fs) and linear amplitudes g_i. On a CUDA tensor
  one launch of ops/multipath_fir makes each tap value in registers at its
  output sample, in fp32 whatever the GEMM policy, from the same phase rows
  and the kept table's distinct rows, and sums the taps (and the TX
  antennas) there: no tap plane is written. On a CPU tensor the taps are the
  product above and each is added into a zeroed buffer from sample d_i on;
  no padded copy of x is made.

- SNR is applied against the measured post-fading power.

Every function that draws takes a seam beside its `torch.Generator`: the
Jakes `phases` (radians), the fading or noise standard normals. A test
feeds the same NumPy numbers to this package and to the JAX package.
"""
from __future__ import annotations

import functools
from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import cplx
from ..cplx import C
from ..config import ITU_CHANNEL_MODELS, ITU_DEFAULT_VELOCITY_KMH, doppler_hz
from ..device import kept
from ..ops.multipath_fir import SinusoidFold, multipath_fir, sinusoid_fold
from ..ops.ofdm import _cmm
from .awgn import awgn, standard_normals

N_SINUSOIDS = 16


class MultipathProfile(NamedTuple):
    """Static channel profile: integer delays (samples), linear tap gains."""

    name: str
    delays_samples: tuple      # ints
    gains_linear: tuple        # floats (amplitude)
    doppler_hz: float
    fs: float

    @property
    def num_taps(self) -> int:
        return len(self.delays_samples)


@functools.lru_cache(maxsize=None)
def make_profile(itu_profile: str, fs: float, velocity_kmh: float = None,
                 frequency_ghz: float = 2.0, fd: float = None,
                 gain_convention: str = "reference") -> MultipathProfile:
    """Build a static multipath profile.

    gain_convention "reference" (default) converts dB -> linear twice,
    10^(10^(dB/20)/20), which makes all ITU taps nearly equal in amplitude
    (Pedestrian_A: 1.122, 1.038, 1.013, 1.008): the effective tap gains of
    the simulator this framework is validated against, kept so that BER
    curves agree with it. "physical" is the single conversion 10^(dB/20)
    of ITU-R M.1225.
    """
    prof = ITU_CHANNEL_MODELS[itu_profile]
    delays_s = np.asarray(prof["delays_us"]) * 1e-6
    lin_once = 10.0 ** (np.asarray(prof["power_db"]) / 20.0)
    if gain_convention == "reference":
        gains_arr = 10.0 ** (lin_once / 20.0)
    elif gain_convention == "physical":
        gains_arr = lin_once
    else:
        raise ValueError(f"unknown gain_convention {gain_convention}")
    gains = tuple(float(g) for g in gains_arr)
    delays = tuple(int(round(d * fs)) for d in delays_s)
    if fd is None:
        v = velocity_kmh if velocity_kmh is not None \
            else ITU_DEFAULT_VELOCITY_KMH[itu_profile]
        fd = doppler_hz(v, frequency_ghz)
    return MultipathProfile(itu_profile + "/" + gain_convention, delays,
                            gains, float(fd), float(fs))


def _omega(fd: float) -> np.ndarray:
    alpha = 2.0 * np.pi * np.arange(1, N_SINUSOIDS + 1) / N_SINUSOIDS
    return (2.0 * np.pi * fd * np.cos(alpha)).astype(np.float32)


def _phases(shape, generator, device, given) -> torch.Tensor:
    """U(0, 2π) phases of `shape`: the generator's, or the caller's."""
    if given is None:
        return torch.rand(shape, generator=generator, device=device,
                          dtype=torch.float32) * (2.0 * np.pi)
    phi = torch.as_tensor(given, dtype=torch.float32, device=device)
    if tuple(phi.shape) != tuple(shape):
        raise ValueError(f"Jakes phases {tuple(phi.shape)}, expected {tuple(shape)}")
    return phi


MAX_TABLES = 8
_tables: "OrderedDict[tuple, C]" = OrderedDict()


def jakes_table(doppler_hz: float, fs: float, num_samples: int, sample_stride: int = 1,
                device=None) -> C:
    """The constant sinusoid table E = exp(j·ω_n·t), (Ns, T), on `device`:
    t runs over T samples of the fs clock, `sample_stride` apart. It is made
    once per (Doppler, fs, T, stride, device) and kept in a plain dict of at
    most `MAX_TABLES` tables, the least recently used dropped first (a link
    sees one or two frame lengths), so a multipath step multiplies by E and
    does not rebuild it. It is evaluated in fp32 on the CPU, so every device
    multiplies by the same numbers."""
    return _kept((float(doppler_hz), float(fs), int(num_samples), int(sample_stride)),
                 lambda: _jakes_table_cpu(doppler_hz, fs, num_samples, sample_stride), device)


def _jakes_table_cpu(doppler_hz: float, fs: float, num_samples: int, sample_stride: int) -> C:
    t = torch.arange(num_samples, dtype=torch.float32) * (sample_stride / fs)
    return cplx.expi(torch.as_tensor(_omega(doppler_hz))[:, None] * t[None, :])


def jakes_fold(doppler_hz: float, fs: float, num_samples: int, sample_stride: int = 1,
               device=None) -> SinusoidFold:
    """The `jakes_table` of these arguments folded (ops/multipath_fir.
    sinusoid_fold): its distinct rows on `device`, and each sinusoid's row and
    sign, found in the CPU table. Kept beside the tables, in the same dict."""
    def to_device(dev):
        fold = sinusoid_fold(_jakes_table_cpu(doppler_hz, fs, num_samples, sample_stride))
        return fold._replace(cos=fold.cos.to(dev), sin=fold.sin.to(dev))

    return kept(_tables, MAX_TABLES, ("fold", float(doppler_hz), float(fs), int(num_samples),
                                      int(sample_stride)), to_device, device)


def symbol_table(doppler_hz: float, num_symbols: int, symbol_duration_s: float,
                 device=None) -> C:
    """The sinusoid table of the flat time-varying channel, E = exp(j·ω_n·t)
    at t = s·symbol_duration_s, (S, Ns) with the symbols leading: kept like
    `jakes_table`, in the same dict."""
    def make():
        t = torch.arange(num_symbols, dtype=torch.float32) * symbol_duration_s
        return cplx.expi(t[:, None] * torch.as_tensor(_omega(doppler_hz))[None, :])

    return _kept(("symbols", float(doppler_hz), int(num_symbols), float(symbol_duration_s)),
                 make, device)


def _kept(key: tuple, make, device) -> C:
    """The table of `key` on `device`: made by make() on the CPU, moved there
    and kept in `_tables` (device.kept)."""
    def to_device(dev):
        E = make()
        return C(E.re.to(dev), E.im.to(dev))

    return kept(_tables, MAX_TABLES, key, to_device, device)


def jakes_taps(profile: MultipathProfile, num_samples: int, batch_shape: tuple = (),
               sample_stride: int = 1, generator: Optional[torch.Generator] = None,
               device=None, phases=None) -> C:
    """Time-varying complex tap gains h_i(t), shape (*batch, num_taps, T).

    One complex GEMM P (batch·taps, Ns) @ E (Ns, T), E the kept `jakes_table`.
    sample_stride evaluates the sinusoids every `stride` samples of the fs
    clock (the tap-hold path of apply_multipath). `phases` (batch·taps, Ns),
    in radians, replaces the generator's draws. The scale √(2/Ns) is applied
    to P, not to the product: one pass over L·Ns values instead of L·T.
    """
    T = num_samples
    table = jakes_table(profile.doppler_hz, profile.fs, T, sample_stride, device)
    P = jakes_rows(profile, batch_shape, generator, device, phases)
    H = _cmm(P, table)                                         # (L, T)
    return H.reshape(tuple(batch_shape) + (profile.num_taps, T))


def jakes_rows(profile: MultipathProfile, batch_shape: tuple = (),
               generator: Optional[torch.Generator] = None, device=None, phases=None) -> C:
    """The scaled phase rows P = exp(jφ)·√(2/Ns), (batch·taps, Ns), of the
    Jakes taps: the generator's U(0, 2π) draws, or `phases` in radians."""
    L = int(np.prod(batch_shape, dtype=int)) * profile.num_taps
    ns = N_SINUSOIDS
    return cplx.expi(_phases((L, ns), generator, device, phases)) * float(np.sqrt(2.0 / ns))


def apply_multipath(x: C, profile: MultipathProfile, hold: int = 1,
                    generator: Optional[torch.Generator] = None, phases=None,
                    links: tuple = (), sum_tx: bool = False) -> C:
    """Faded signal y(t) = Σ_i g_i h_i(t) x(t−d_i); x: (..., T) -> (*links, ..., T).

    Fresh fading per call. `links` adds leading axes of independent
    channels that all carry x (one per antenna leg). hold: generate the
    taps every `hold` samples and hold them inside the block (1 = a tap
    value per sample, the exact form). A hold that does not divide T is
    rounded down to the largest divisor of T. sum_tx: x's first axis is the
    TX antennas, each with its own links, and the result is their sum,
    (*links, x.shape[1:]); `phases` stay (links, tx, lanes, taps) rows.

    On a CUDA tensor `multipath_fused` (one launch of ops/multipath_fir,
    under every GEMM policy and form); on a CPU tensor `multipath_unfused`.
    """
    route = multipath_fused if x.re.device.type == "cuda" else multipath_unfused
    return route(x, profile, hold, generator, phases, links, sum_tx)


def multipath_fused(x: C, profile: MultipathProfile, hold: int = 1,
                    generator: Optional[torch.Generator] = None, phases=None,
                    links: tuple = (), sum_tx: bool = False) -> C:
    """apply_multipath as one multipath_fir call: the phase rows drawn as
    `jakes_taps` draws them, the kept table's fold, x and y as (tx or 1,
    lanes, T) and (links, lanes, T). On a CPU tensor multipath_fir runs its
    plain version."""
    dev = x.re.device
    T = x.shape[-1]
    hold = _divisor_hold(hold, T)
    lanes = tuple(x.shape[1:-1]) if sum_tx else tuple(x.shape[:-1])
    n_tx, n_lanes = (x.shape[0] if sum_tx else 1), int(np.prod(lanes, dtype=int))
    n_rx = int(np.prod(links, dtype=int))
    rows = jakes_rows(profile, tuple(links) + tuple(x.shape[:-1]), generator, dev, phases)
    y = multipath_fir(C(x.re.reshape(n_tx, n_lanes, T).contiguous(),
                        x.im.reshape(n_tx, n_lanes, T).contiguous()),
                      rows.reshape(n_rx, n_tx, n_lanes, profile.num_taps, N_SINUSOIDS),
                      jakes_fold(profile.doppler_hz, profile.fs, T // hold, hold, dev),
                      profile.delays_samples, profile.gains_linear, hold)
    return y.reshape(tuple(links) + lanes + (T,))


def _divisor_hold(hold: int, T: int) -> int:
    hold = max(1, int(hold))
    if hold > 1 and T % hold:
        hold = next(h for h in range(min(hold, T), 0, -1) if T % h == 0)
    return hold


def multipath_unfused(x: C, profile: MultipathProfile, hold: int = 1,
                      generator: Optional[torch.Generator] = None, phases=None,
                      links: tuple = (), sum_tx: bool = False) -> C:
    """apply_multipath as the Jakes product (`jakes_taps`) and a FIR over its
    tap planes: each tap added into a zeroed (*links, ..., T) buffer, then
    the sum over TX. The path of a CPU tensor, which the JAX-parity tests
    hold."""
    T = x.shape[-1]
    batch = tuple(links) + tuple(x.shape[:-1])
    hold = _divisor_hold(hold, T)
    taps = jakes_taps(profile, T // hold, batch, sample_stride=hold, generator=generator,
                      device=x.re.device, phases=phases)       # (..., taps, Tg)

    y = cplx.czeros(batch + (T,), x.re.device)
    for i, (d, g) in enumerate(zip(profile.delays_samples, profile.gains_linear)):
        if d >= T:
            continue
        h = taps[..., i, :]
        if hold > 1:
            # the held tap value of output sample t is h[t // hold]
            h = C(h.re.repeat_interleave(hold, dim=-1), h.im.repeat_interleave(hold, dim=-1))
        # y[d:] += g·h[d:]·x[:T-d], four in-place fused multiply-adds a tap
        # (no product or shifted copy of x is written out)
        hr, hi = h.re[..., d:], h.im[..., d:]
        xr, xi = x.re[..., :T - d], x.im[..., :T - d]
        y.re[..., d:].addcmul_(hr, xr, value=g).addcmul_(hi, xi, value=-g)
        y.im[..., d:].addcmul_(hr, xi, value=g).addcmul_(hi, xr, value=g)
    return y.sum(axis=len(links)) if sum_tx else y


def rayleigh_multipath(x: C, snr_db, profile: MultipathProfile, measure_axes=None,
                       generator: Optional[torch.Generator] = None, phases=None,
                       noise=None, hold: int = 1, links: tuple = ()) -> C:
    """Multipath fading + AWGN at SNR relative to post-fading power."""
    y = apply_multipath(x, profile, hold, generator, phases, links)
    return awgn(y, snr_db, measure_axes=measure_axes, generator=generator, noise=noise)


def _cn01(shape, generator: Optional[torch.Generator] = None, device=None,
          normals=None) -> C:
    """CN(0, 1) of `shape`; `normals` is the (re, im) seam of standard normals."""
    n = standard_normals(shape, generator, device, normals, "fading")
    s = float(1.0 / np.sqrt(2.0))
    return C(n.re * s, n.im * s)


def flat_fading(x: C, snr_db, generator: Optional[torch.Generator] = None,
                fading=None, noise=None) -> C:
    """Per-sample iid CN(0,1) multiplicative fading + AWGN; the noise power
    is measured over the whole batch, not per lane."""
    h = _cn01(x.shape, generator, x.re.device, fading)
    return awgn(h * x, snr_db, generator=generator, noise=noise)


def flat_mimo_matrix(num_rx: int, num_tx: int, batch_shape: tuple = (),
                     generator: Optional[torch.Generator] = None, device=None,
                     normals=None) -> C:
    """iid CN(0,1) flat MIMO link matrix H[..., rx, tx]."""
    return _cn01(tuple(batch_shape) + (num_rx, num_tx), generator, device, normals)


def flat_mimo_time_varying(num_rx: int, num_tx: int, num_symbols: int, doppler_hz: float,
                           symbol_duration_s: float = 1.0 / 15000.0,
                           batch_shape: tuple = (),
                           generator: Optional[torch.Generator] = None, device=None,
                           phases=None) -> C:
    """Jakes-evolved flat MIMO channel H[..., s, rx, tx], one sample per OFDM
    symbol, each (rx, tx) element fading independently with unit power
    (E|h|² = 1, unlike the multipath taps' 2). `phases` is (Ns, batch·rx·tx).

    One small complex product E (S, Ns) @ P (Ns, L) through `_cmm`, like
    every other product: K = 16 as in jakes_taps, S a frame's symbols and L
    the links of all lanes. E is the kept `symbol_table`."""
    S, ns = num_symbols, N_SINUSOIDS
    batch_shape = tuple(batch_shape)
    E = symbol_table(doppler_hz, S, symbol_duration_s, device)  # (S, Ns)

    L = int(np.prod(batch_shape, dtype=int)) * num_rx * num_tx
    P = cplx.expi(_phases((ns, L), generator, device, phases))

    H = _cmm(E, P) * float(np.sqrt(1.0 / ns))
    H = H.reshape((S,) + batch_shape + (num_rx, num_tx))       # (S, ..., r, t)
    nb = len(batch_shape)
    return H.transpose(*range(1, 1 + nb), 0, 1 + nb, 2 + nb)   # (..., S, r, t)


def impulse_response(profile: MultipathProfile,
                     generator: Optional[torch.Generator] = None, device=None,
                     phases=None):
    """One instantaneous complex tap per path: (delays_samples, taps C)."""
    taps = jakes_taps(profile, 1, (), generator=generator, device=device,
                      phases=phases)                           # (num_taps, 1)
    g = torch.tensor(profile.gains_linear, dtype=torch.float32, device=device)
    return (np.asarray(profile.delays_samples),
            C(taps.re[:, 0] * g, taps.im[:, 0] * g))


def frequency_response(taps: C, profile: MultipathProfile, freqs_hz: torch.Tensor) -> C:
    """Analytic H(f) = Σ h_i·exp(-2πi·f·τ_i) for given instantaneous taps.
    taps: C (num_taps,)."""
    dev = taps.re.device
    tau = torch.tensor(profile.delays_samples, dtype=torch.float32, device=dev) / profile.fs
    f = torch.as_tensor(freqs_hz, dtype=torch.float32, device=dev)
    e = cplx.expi(-2.0 * np.pi * f[..., None] * tau)           # (..., taps)
    return (taps * e).sum(axis=-1)


def path_loss_linear(distance_m, frequency_hz=2e9, pl0_db: float = 30.0,
                     exponent: float = 3.5, shadowing_sigma_db: float = 4.0,
                     d0: float = 100.0, generator: Optional[torch.Generator] = None,
                     device=None, shadow=None) -> torch.Tensor:
    """Log-distance path loss + log-normal shadowing as a linear amplitude:
        PL(dB) = PL0 + 10·n·log10(d/d0) + N(0, σ);  return 10^(-PL/20).
    `shadow` is the seam: standard normals shaped like distance_m."""
    d = torch.as_tensor(distance_m, dtype=torch.float32, device=device)
    pl_db = pl0_db + 10.0 * exponent * torch.log10(d / d0)
    if shadow is None:
        shadow = torch.randn(d.shape, generator=generator, device=d.device,
                             dtype=torch.float32)
    shadow = torch.as_tensor(shadow, dtype=torch.float32, device=d.device)
    return 10.0 ** (-(pl_db + shadow * shadowing_sigma_db) / 20.0)
