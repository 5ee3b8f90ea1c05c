"""Turbo-coded SISO downlink chain: CRC-24A, segmentation, turbo code, rate
matching, block interleaving, the OFDM link and soft demodulation, with
HARQ.

Port of ofdm_lte_tpu/sim/coded.py, whose semantics it keeps:

- E = 3K+12 (no puncturing), redundancy version rv 0-3 (default 0);
- a row/column time-frequency symbol interleaver: rows of n_data QAM
  symbols written, columns read;
- the AWGN noise (or the Jakes/ITU multipath channel) is applied in the
  time domain to the whole transport block's signal, measured per lane
  (`measure_axes=(-1,)`), not at the bins as the uncoded main path does;
- slot-periodic CRS estimation and per-symbol ZF, H collected at the data
  bins; per-subcarrier noise variance σ²/|Ĥ|², |Ĥ|² clipped to [1e-6,
  1e6], floored at σ²/4, for every channel (PARITY.md "LLR noise
  weighting");
- max-log LLRs clipped to ±10 (QPSK unclipped), 8 decoder iterations by
  default, CRC-24A on the desegmented transport block;
- HARQ: the turbo code once, then each transmission rate-matched at its rv,
  sent under its own draws, de-rate-matched and added into the encoder-
  domain LLR accumulator, and a combined decode after each.

`CodedLink` (an nn.Module) holds every table of one (config, transport-
block size) as buffers: the modem's GEMM tables (a SisoLink), the QPP and
rate-matching index tensors and the CRC matrices; the segmentation layout,
block offsets and group sizes are host-static, so `forward` reads no device
value. Its `forward` is the batched chain (leading axes of `bits` are
Monte-Carlo lanes, snr_db a scalar or one per lane) and `harq` the batched
HARQ schedule, where a lane's result freezes at its first CRC pass (a
masked `where`; every lane runs every stage). `simulate_siso_coded` and
`simulate_siso_coded_harq` are the host paths: one transport block,
CRC/segmentation on the host, HARQ breaking at the first pass.

Seams for the draws (`draws=`), one transmission: {"noise": (re, im)}
standard normals shaped like the signal, (..., S·(N+cp)); over multipath
also {"phases": (lanes·taps, 16)} in radians. For HARQ every array has a
leading axis of T transmissions. Without them a torch.Generator draws.

Under a torch.profiler the stages record spans (utils/profiling.span):
`coding.crc` (CRC attachment with the code-block gather, and the check),
`coding.encode`, `coding.rate_match` (and de-matching), `coding.decode`
(the turbo iterations and the desegmenting gather), `coding.harq_combine`
(the soft combining and the lanes' freeze), the modem's and the channel's
spans of one transmission, `link.errors`, and `link.host_sync` where a host
path waits for the decoded bits.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

import numpy as np
import torch
from torch import nn

from .. import cplx
from ..channel.awgn import awgn
from ..channel.rayleigh import make_profile, rayleigh_multipath
from ..coding import crc, segmentation, turbo
from ..coding import rate_matching as rm
from ..config import LTEConfig
from ..cplx import C
from ..device import resolve_device
from ..grid import grid_for
from ..ops import ofdm, qam
from ..rx import estimation as est
from ..utils.profiling import span
from .links import cached_link
from .siso import SisoLink


class CodedResult(NamedTuple):
    bits_rx: np.ndarray
    bit_errors: int
    ber: float
    crc_pass: bool
    papr_db: float
    coded_bits_length: int
    channel_snr_db: float


class CodedBatchResult(NamedTuple):
    bits_rx: torch.Tensor       # (..., n_bits), the caller's bit dtype
    bit_errors: torch.Tensor    # (...,) int32
    ber: torch.Tensor           # (...,) float32
    crc_pass: torch.Tensor      # (...,) bool
    papr_db: torch.Tensor       # (...,) float32


class HarqResult(NamedTuple):
    bits_rx: np.ndarray
    bit_errors: int
    ber: float
    crc_pass: bool
    num_transmissions: int
    rv_history: tuple
    crc_history: tuple          # CRC outcome after each combined decode


class HarqBatchResult(NamedTuple):
    bits_rx: torch.Tensor            # (..., n_bits), the decode a lane froze at
    bit_errors: torch.Tensor         # (...,) int32
    ber: torch.Tensor                # (...,) float32
    crc_pass: torch.Tensor           # (...,) bool, passed at any stage
    num_transmissions: torch.Tensor  # (...,) int32, 1..T (T if never passed)
    crc_pass_stage: torch.Tensor     # (..., T) bool, passed at any stage <= t
    papr_db: torch.Tensor            # (...,) float32, first transmission


def _transpose_flatten(x: C, a: int, b: int) -> C:
    """Row/column block interleave on the last axis: write (a, b) rows,
    read columns, batched over the leading axes."""
    lead = tuple(x.shape[:-1])
    y = x.reshape(lead + (a, b))
    return C(y.re.transpose(-1, -2), y.im.transpose(-1, -2)).reshape(lead + (a * b,))


def _draws_at(draws: Optional[dict], t: int) -> Optional[dict]:
    """Transmission t's draws out of HARQ draws with a leading T axis."""
    if draws is None:
        return None

    def pick(v):
        return tuple(pick(x) for x in v) if isinstance(v, tuple) else v[t]
    return {k: pick(v) for k, v in draws.items()}


class CodedLink(nn.Module):
    """The coded chain of one (config, transport-block size), its tables as
    buffers.

    forward(bits, snr_db, rv=0, num_iterations=8, use_max_log=None,
    generator=None, draws=None) -> CodedBatchResult and harq(bits, snr_db,
    rv_sequence=(0, 1, 2, 3), ...) -> HarqBatchResult run one Monte-Carlo
    step; the stages (blocks, encode, rate_match, link_llrs, dematch,
    decode_blocks, desegment, check) are methods too, which the host paths
    share. channel_type "awgn", or anything else for Jakes/ITU multipath
    (as in the JAX package)."""

    def __init__(self, config: LTEConfig, tb_bits: int, device=None,
                 channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                 velocity_kmh: Optional[float] = None):
        super().__init__()
        device = resolve_device(device)
        self.config = config
        self.tb_bits = int(tb_bits)
        self.channel_type = channel_type
        self.profile = (None if channel_type == "awgn"
                        else make_profile(itu_profile, config.fs, velocity_kmh, 2.0))
        self.modem = SisoLink(config, device)
        B = self.tb_bits + 24
        lay = segmentation.segment_layout(B)
        self.segmented = lay["segmented"]
        groups = OrderedDict()
        for r, K in enumerate(lay["sizes"]):
            groups.setdefault(K, []).append(r)
        # equal-K blocks go through the turbo code as one batch; in the
        # layout the K- blocks come first, so the groups are in block order
        self.groups = [(K, len(idxs)) for K, idxs in groups.items()]
        self.coded_len = sum(n * (3 * K + 12) for K, n in self.groups)

        def buf(name, arr):
            self.register_buffer(name, torch.as_tensor(np.ascontiguousarray(arr), device=device))

        buf("crc_tb", crc.crc_matrix(self.tb_bits, crc.CRC24A_POLY, 24))
        deseg, offset = [], 0
        for K, idxs in groups.items():
            body = K - 24 if self.segmented else K
            gather = np.full((len(idxs), body), B, np.int64)   # B: the zero slot
            for j, r in enumerate(idxs):
                F, I, P = lay["fillers"][r], lay["info"][r], lay["positions"][r]
                gather[j, F:F + I] = P + np.arange(I)
                deseg.append(offset + j * K + F + np.arange(I))
            offset += len(idxs) * K
            buf(f"blocks_{K}", gather)
            if self.segmented:
                buf(f"crc_body_{K}", crc.crc_matrix(K - 24, crc.CRC24B_POLY, 24))
            buf(f"qpp_{K}", turbo.qpp_indices(K).astype(np.int32))
            buf(f"qpp_inv_{K}", turbo.qpp_inverse_indices(K).astype(np.int32))
            for rv in range(4):
                buf(f"rm_fwd_{K}_{rv}", rm.forward_indices(K, 3 * K + 12, rv).astype(np.int64))
            buf(f"rm_dematch_{K}", rm._enc_from_cb(K).astype(np.int64))
        buf("deseg", np.concatenate(deseg))

    def _t(self, name: str, K: int) -> torch.Tensor:
        return getattr(self, f"{name}_{K}")

    @property
    def device(self) -> torch.device:
        return self.crc_tb.device

    # -- TX ------------------------------------------------------------------
    def blocks(self, bits: torch.Tensor) -> dict:
        """CRC-24A, then the code blocks by size, {K: (..., n_K, K) int32}:
        the layout's filler/info placement as one gather, and CRC-24B on
        each block when the transport block is segmented."""
        with span("coding.crc"):
            b = bits.to(torch.int32)
            lead = tuple(b.shape[:-1])
            tb = torch.cat([b, crc.crc_torch(b, crc.CRC24A_POLY, 24, M=self.crc_tb),
                            b.new_zeros(lead + (1,))], dim=-1)
            out = {}
            for K, n in self.groups:
                idx = self._t("blocks", K)
                body = torch.index_select(tb, -1, idx.reshape(-1)).reshape(lead
                                                                           + tuple(idx.shape))
                if self.segmented:
                    body = torch.cat([body, crc.crc_torch(body, crc.CRC24B_POLY, 24,
                                                          M=self._t("crc_body", K))], dim=-1)
                out[K] = body
            return out

    def encode(self, blocks: dict) -> dict:
        """{K: turbo-encoded (..., n_K, 3K+12)}: rv-independent, so HARQ
        encodes once."""
        with span("coding.encode"):
            return {K: turbo.turbo_encode(blocks[K], K, self._t("qpp", K)) for K in blocks}

    def rate_match(self, enc: dict, rv: int) -> torch.Tensor:
        """Every block rate-matched at rv, laid end to end: (..., coded_len)."""
        with span("coding.rate_match"):
            parts = []
            for K, n in self.groups:
                out = rm.rate_match(enc[K], 3 * K + 12, K, rv, fwd=self._t(f"rm_fwd_{K}", rv))
                parts.append(out.reshape(tuple(out.shape[:-2]) + (n * (3 * K + 12),)))
            return torch.cat(parts, dim=-1)

    # -- the link ------------------------------------------------------------
    def link_llrs(self, coded: torch.Tensor, snr_db, generator: Optional[torch.Generator] = None,
                  draws: Optional[dict] = None):
        """One transmission of the coded stream (..., coded_len): QAM, the
        block interleave, the grid, IDFT and CP (one GEMM), the channel in the
        time domain, the DFTs to the data and slot-start pilot bins (two
        GEMMs), CRS estimation and ZF, the de-interleave, the per-subcarrier
        noise variance and the soft demap. Returns (llrs (..., coded_len),
        papr_db (...,), pilot snr dB (...,))."""
        cfg, g = self.config, grid_for(self.config)
        nd, bps = g.num_data, cfg.bits_per_symbol
        lead = tuple(coded.shape[:-1])
        coded_len = coded.shape[-1]
        pad_b = (-coded_len) % bps
        n_sym = (coded_len + pad_b) // bps
        rows = -(-n_sym // nd)
        total = rows * nd
        modem = self.modem
        with span("modem.tx"):
            syms = qam.modulate(torch.nn.functional.pad(coded, (0, pad_b)), cfg.modulation)
            syms = cplx.pad(syms, [(0, 0)] * len(lead) + [(0, total - n_sym)])
            data_syms = _transpose_flatten(syms, rows, nd).reshape(lead + (rows, nd))
            tx = ofdm.modulate_symbols(data_syms, cfg, 0, modem.mod_tables)   # (..., S, N+cp)
            sig = tx.reshape(lead + (rows * cfg.samples_per_ofdm_symbol,))
        with span("modem.papr"):
            papr = ofdm.papr_db(sig, axis=-1)
        draws = draws or {}
        if self.channel_type == "awgn":
            with span("channel.awgn"):
                rx = awgn(sig, snr_db, (-1,), generator, draws.get("noise"))
        else:
            with span("channel.multipath"):
                rx = rayleigh_multipath(sig, snr_db, self.profile, (-1,), generator,
                                        draws.get("phases"), draws.get("noise"))

        rt = modem.rx_tables
        with span("modem.rx_dft"):
            y = ofdm.frame_stream(rx, cfg)
            y_data = ofdm.demodulate_bins(y, cfg, g.data_idx, rt.data)
            # the slot-start symbols: a view the GEMM reads in place when the
            # frame holds one slot; with more slots and S not a multiple of 14 the
            # wrapper copies the two planes (counted in cmatmul.copies)
            y_pil = ofdm.demodulate_bins(y[..., ::est.SLOT_SIZE, :], cfg, g.pilot_idx,
                                         rt.pilot)
        with span("modem.estimate"):
            h_pil = est.ls_at_pilots(y_pil, 0, rt.known)
            psnr = est.pilot_snr_db(y_pil, 0, axis=(-2, -1), known=rt.known)
            h_slots = est.interpolate(h_pil, cfg, out_bins=g.data_idx, table=rt.interp)
            h_data = est.slot_periodic(h_slots, rows)
            x_eq = est.zf_equalize(y_data, h_data)

        with span("modem.demap"):
            de = _transpose_flatten(x_eq.reshape(lead + (total,)), nd, rows)[..., :n_sym]
            h_de = _transpose_flatten(h_data.reshape(lead + (total,)), nd, rows)[..., :n_sym]
            h_pow = torch.clamp(h_de.abs2(), 1e-6, 1e6)
            if isinstance(snr_db, torch.Tensor) or np.ndim(snr_db):
                snr = torch.as_tensor(snr_db, dtype=torch.float32, device=h_pow.device)
                s2 = 10.0 ** (-snr / 10.0)
                s2 = s2[..., None] if s2.ndim else s2
                noise_var = torch.maximum(s2 / h_pow, s2 / 4.0)
            else:
                # a Python scalar, as the JAX package's host path takes it
                s2 = 1.0 / (10.0 ** (float(snr_db) / 10.0))
                noise_var = torch.clamp(s2 / h_pow, min=s2 / 4.0)
            llrs = qam.llrs(de, noise_var, cfg.modulation)[..., :coded_len]
        return llrs, papr, psnr

    # -- RX ------------------------------------------------------------------
    def dematch(self, llrs: torch.Tensor, rv: int) -> dict:
        """Each block's LLRs de-rate-matched to encoder order, the soft-
        combining domain: {K: (..., n_K, 3K+12)}."""
        lead = tuple(llrs.shape[:-1])
        out, off = {}, 0
        with span("coding.rate_match"):
            for K, n in self.groups:
                E = 3 * K + 12
                part = llrs[..., off:off + n * E].reshape(lead + (n, E))
                out[K] = rm.rate_dematch(part, K, rv, enc_from_cb=self._t("rm_dematch", K))
                off += n * E
        return out

    def decode_blocks(self, acc: dict, num_iterations: int, use_max_log: bool) -> dict:
        """{K: hard bits (..., n_K, K)} from encoder-domain LLRs."""
        with span("coding.decode"):
            return {K: turbo.turbo_decode(acc[K], K, num_iterations, use_max_log,
                                          self._t("qpp", K), self._t("qpp_inv", K))
                    for K in acc}

    def desegment(self, dec: dict) -> torch.Tensor:
        """The received transport block (..., B) out of the decoded blocks:
        the information bits of each, without fillers or CRC-24B, one gather."""
        lead = tuple(dec[self.groups[0][0]].shape[:-2])
        with span("coding.decode"):
            flat = torch.cat([dec[K].reshape(lead + (n * K,)) for K, n in self.groups], dim=-1)
            return torch.index_select(flat, -1, self.deseg)

    def check(self, tb_rx: torch.Tensor) -> torch.Tensor:
        """CRC-24A of the received transport blocks (..., B): pass (...,) bool."""
        n = self.tb_bits
        with span("coding.crc"):
            rem = crc.crc_torch(tb_rx[..., :n], crc.CRC24A_POLY, 24, M=self.crc_tb)
            return torch.all(rem == tb_rx[..., n:], dim=-1)

    def _bits(self, bits: torch.Tensor) -> torch.Tensor:
        if bits.shape[-1] != self.tb_bits:
            raise ValueError(f"bits {tuple(bits.shape)}: this link carries {self.tb_bits}-bit "
                             "transport blocks")
        return bits.to(self.device)

    def _errors(self, bits_rx: torch.Tensor, bits: torch.Tensor):
        errors = (bits_rx != bits).sum(dim=-1, dtype=torch.int32)
        return errors, errors / float(self.tb_bits)

    # -- one step --------------------------------------------------------------
    def forward(self, bits: torch.Tensor, snr_db, rv: int = 0, num_iterations: int = 8,
                use_max_log: Optional[bool] = None, generator: Optional[torch.Generator] = None,
                draws: Optional[dict] = None) -> CodedBatchResult:
        if use_max_log is None:
            use_max_log = turbo.USE_MAX_LOG_MAP
        bits = self._bits(bits)
        coded = self.rate_match(self.encode(self.blocks(bits)), rv)
        llrs, papr, _ = self.link_llrs(coded, snr_db, generator, draws)
        tb_rx = self.desegment(self.decode_blocks(self.dematch(llrs, rv), num_iterations,
                                                  bool(use_max_log)))
        with span("link.errors"):
            bits_rx = tb_rx[..., :self.tb_bits].to(bits.dtype)
            errors, ber = self._errors(bits_rx, bits)
        return CodedBatchResult(bits_rx, errors, ber, self.check(tb_rx), papr)

    def harq(self, bits: torch.Tensor, snr_db, rv_sequence=(0, 1, 2, 3), num_iterations: int = 8,
             use_max_log: Optional[bool] = None, generator: Optional[torch.Generator] = None,
             draws: Optional[dict] = None) -> HarqBatchResult:
        """HARQ with chase/IR combining over rv_sequence, batched: every lane
        runs every stage, and its result freezes at its first CRC pass;
        crc_pass_stage[..., t] is "passed at any stage <= t"."""
        if use_max_log is None:
            use_max_log = turbo.USE_MAX_LOG_MAP
        bits = self._bits(bits)
        n, T = self.tb_bits, len(rv_sequence)
        lead = tuple(bits.shape[:-1])
        enc = self.encode(self.blocks(bits))
        acc, papr0, stages = None, None, []
        with span("coding.harq_combine"):
            done = torch.zeros(lead, dtype=torch.bool, device=bits.device)
            num_tx = torch.zeros(lead, dtype=torch.int32, device=bits.device)
            bits_rx = torch.zeros(lead + (n,), dtype=torch.int32, device=bits.device)
        for t, rv in enumerate(rv_sequence):
            llrs, papr, _ = self.link_llrs(self.rate_match(enc, int(rv)), snr_db, generator,
                                           _draws_at(draws, t))
            papr0 = papr if papr0 is None else papr0
            dem = self.dematch(llrs, int(rv))
            with span("coding.harq_combine"):
                acc = dem if acc is None else {K: acc[K] + dem[K] for K in acc}
            tb_rx = self.desegment(self.decode_blocks(acc, num_iterations, bool(use_max_log)))
            passed = self.check(tb_rx)
            with span("coding.harq_combine"):
                # a lane keeps the decode of its first passing stage; one that
                # never passes keeps the last stage's
                take = ~done if t == T - 1 else passed & ~done
                bits_rx = torch.where(take[..., None], tb_rx[..., :n], bits_rx)
                num_tx = torch.where(done, num_tx, t + 1)
                done = done | passed
                stages.append(done)
        with span("link.errors"):
            bits_rx = bits_rx.to(bits.dtype)
            errors, ber = self._errors(bits_rx, bits)
            crc_pass_stage = torch.stack(stages, dim=-1)
        return HarqBatchResult(bits_rx, errors, ber, done, num_tx, crc_pass_stage, papr0)


def link_for(config: LTEConfig, tb_bits: int, device, channel_type: str = "awgn",
             itu_profile: str = "Pedestrian_A", velocity_kmh: Optional[float] = None) -> CodedLink:
    """The CodedLink of these arguments, built once and kept (sim.links)."""
    return cached_link(CodedLink, config, int(tb_bits), resolve_device(device), channel_type,
                       itu_profile, velocity_kmh)


def simulate_siso_coded_batched(bits: torch.Tensor, snr_db, config: LTEConfig,
                                channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                                velocity_kmh: Optional[float] = None, num_iterations: int = 8,
                                use_max_log: Optional[bool] = None, rv: int = 0,
                                generator: Optional[torch.Generator] = None, device=None,
                                draws: Optional[dict] = None) -> CodedBatchResult:
    """The whole coded chain batched over the leading axes of bits
    (..., n_bits); snr_db a scalar or one per lane. Runs on `device`, the
    CUDA card when none is given (bits are moved there)."""
    link = link_for(config, bits.shape[-1], device, channel_type, itu_profile, velocity_kmh)
    return link(bits, snr_db, rv, num_iterations, use_max_log, generator, draws)


def simulate_siso_coded_harq_batched(bits: torch.Tensor, snr_db, config: LTEConfig,
                                     rv_sequence=(0, 1, 2, 3), channel_type: str = "awgn",
                                     itu_profile: str = "Pedestrian_A",
                                     velocity_kmh: Optional[float] = None,
                                     num_iterations: int = 8,
                                     use_max_log: Optional[bool] = None,
                                     generator: Optional[torch.Generator] = None, device=None,
                                     draws: Optional[dict] = None) -> HarqBatchResult:
    """Batched HARQ chase combining (CodedLink.harq): bits (..., n_bits),
    `draws` with a leading axis of len(rv_sequence) transmissions."""
    link = link_for(config, bits.shape[-1], device, channel_type, itu_profile, velocity_kmh)
    return link.harq(bits, snr_db, tuple(int(r) for r in rv_sequence), num_iterations,
                     use_max_log, generator, draws)


def _host_blocks(link: CodedLink, blocks, meta) -> dict:
    """The host segmentation's code blocks, grouped by size, on the device."""
    out = {}
    for K, _ in link.groups:
        idxs = [i for i, k in enumerate(meta["block_sizes"]) if k == K]
        out[K] = torch.as_tensor(np.stack([blocks[i] for i in idxs]).astype(np.int32),
                                 device=link.device)
    return out


def _host_decode(link: CodedLink, acc: dict, meta, n_orig: int, num_iterations: int,
                 use_max_log: bool):
    """Grouped decode on the device, desegmentation and CRC-24A on the host."""
    dec = link.decode_blocks(acc, num_iterations, use_max_log)
    with span("link.host_sync"):
        dec = {K: v.cpu().numpy() for K, v in dec.items()}
    dec_blocks, seen = [], {K: 0 for K in dec}
    for K in meta["block_sizes"]:
        dec_blocks.append(dec[K][seen[K]].astype(np.uint8))
        seen[K] += 1
    tb_rx = segmentation.desegment_code_blocks(dec_blocks, meta)
    crc_pass = crc.check_crc24a(tb_rx)
    bits_rx = tb_rx[:-24] if len(tb_rx) >= 24 else tb_rx
    if len(bits_rx) < n_orig:
        bits_rx = np.pad(bits_rx, (0, n_orig - len(bits_rx)))
    return bits_rx[:n_orig], crc_pass


def simulate_siso_coded(bits, snr_db: float, config: LTEConfig, channel_type: str = "awgn",
                        itu_profile: str = "Pedestrian_A", velocity_kmh: Optional[float] = None,
                        num_iterations: int = 8, use_max_log: Optional[bool] = None, rv: int = 0,
                        generator: Optional[torch.Generator] = None, device=None,
                        draws: Optional[dict] = None) -> CodedResult:
    """One transport block (NumPy bits) through the whole TS 36.212 chain at
    redundancy version rv: CRC and segmentation on the host, the turbo code,
    the link and the decoder on `device` (the CUDA card when none is given)."""
    if use_max_log is None:
        use_max_log = turbo.USE_MAX_LOG_MAP
    bits = np.asarray(bits).astype(np.uint8)
    n_orig = len(bits)
    link = link_for(config, n_orig, device, channel_type, itu_profile, velocity_kmh)
    blocks, meta = segmentation.segment_code_blocks(crc.attach_crc24a(bits))
    coded = link.rate_match(link.encode(_host_blocks(link, blocks, meta)), rv)
    llrs, papr, psnr = link.link_llrs(coded, float(snr_db), generator, draws)
    bits_rx, crc_pass = _host_decode(link, link.dematch(llrs, rv), meta, n_orig,
                                     num_iterations, bool(use_max_log))
    errors = int(np.sum(bits_rx != bits))
    return CodedResult(bits_rx, errors, errors / n_orig, crc_pass, float(papr),
                       int(coded.shape[-1]), float(psnr))


def simulate_siso_coded_harq(bits, snr_db: float, config: LTEConfig, rv_sequence=(0, 1, 2, 3),
                             channel_type: str = "awgn", itu_profile: str = "Pedestrian_A",
                             velocity_kmh: Optional[float] = None, num_iterations: int = 8,
                             use_max_log: Optional[bool] = None,
                             generator: Optional[torch.Generator] = None, device=None,
                             draws: Optional[dict] = None) -> HarqResult:
    """HARQ on the host: retransmit the transport block at successive
    redundancy versions until CRC-24A passes, soft-combining the
    de-rate-matched LLRs of every transmission in the encoder domain.
    `draws` has a leading axis of len(rv_sequence) transmissions; the loop
    stops at the first pass."""
    if use_max_log is None:
        use_max_log = turbo.USE_MAX_LOG_MAP
    bits = np.asarray(bits).astype(np.uint8)
    n_orig = len(bits)
    link = link_for(config, n_orig, device, channel_type, itu_profile, velocity_kmh)
    blocks, meta = segmentation.segment_code_blocks(crc.attach_crc24a(bits))
    enc = link.encode(_host_blocks(link, blocks, meta))
    acc, crc_hist, bits_rx = None, [], None
    for t, rv in enumerate(rv_sequence):
        llrs, _, _ = link.link_llrs(link.rate_match(enc, int(rv)), float(snr_db), generator,
                                    _draws_at(draws, t))
        dem = link.dematch(llrs, int(rv))
        acc = dem if acc is None else {K: acc[K] + dem[K] for K in acc}
        bits_rx, crc_pass = _host_decode(link, acc, meta, n_orig, num_iterations,
                                         bool(use_max_log))
        crc_hist.append(bool(crc_pass))
        if crc_pass:
            break
    errors = int(np.sum(bits_rx != bits))
    return HarqResult(bits_rx, errors, errors / n_orig, crc_hist[-1], len(crc_hist),
                      tuple(rv_sequence[:len(crc_hist)]), tuple(crc_hist))
