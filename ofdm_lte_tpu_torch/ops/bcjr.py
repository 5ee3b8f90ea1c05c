"""One BCJR pass over a batch of terminated code blocks, and the turbo
decoder's half-iteration around it: the CUDA kernel's wrappers and their
plain versions.

The turbo decoder's constituent pass (coding/turbo._bcjr): from the
systematic, parity and a-priori LLRs of K' = K + 3 trellis steps, the
a-posteriori LLRs of every step, with the trellis started and ended in
state 0. The JAX package runs it as two lax.scans
(ofdm_lte_tpu/coding/turbo.py:424-448, its "scan" form); eager PyTorch would
make that a Python loop of some 10 launches a step, about 10^6 a decode,
so on a card one launch does a whole pass for every code block:

- `bcjr_app(l_sys, l_par, l_apr)`: the APP LLRs (..., K') of one pass;
- `bcjr_half(l_sys, l_par, ext_in, index)`: one half-iteration of the
  decoder (ofdm_lte_tpu/coding/turbo.py:495-517) in one launch: the
  a-priori of step k < K is ext_in[index[k]] (the other decoder's
  extrinsic through π or π⁻¹; zeros when ext_in is None) and 0 on the
  three tail steps, and the result is the extrinsic (APP − a-priori) −
  L_sys in this decoder's order, or with `hard=True` the bits APP < 0
  (..., K) int32. The extrinsic planes are step-major, (K, ...): the
  kernel's QPP gather then reads neighbouring blocks from one sector.

On a CPU tensor each runs its plain version (`bcjr_plain`, a loop over the
K' steps that repeats the "scan" form's arithmetic op for op, and
`bcjr_half_plain`, the gather, `cat`, `bcjr_plain` and subtraction as
the JAX package's decoder does them); on a CUDA tensor it launches
csrc/turbo_bcjr.cu (`turbo_bcjr`), built on first use (_build.py), or
raises. It never falls back to the plain version. Each launch adds one to
its wrapper's `launches`.

Both semirings: max-log (⊕ = max) and exact log-MAP (⊕ = log-sum-exp).
Under max-log every operation is an add of ±L/2 terms or a max, so the
kernel, the plain version and the JAX package agree as floats; under
log-MAP expf/logf and the order of the 8-state sums differ by a few ulps.

The trellis (TS 36.212's 8-state RSC, g0 = 013 feedback, g1 = 015) is the
JAX package's, with its quirk that the systematic output is the feedback
bit: `trellis_tables` and `reverse_trellis` are copies of
ofdm_lte_tpu/coding/turbo.py:110-141.
"""
from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

NEG = -1e9          # the metric of a state the trellis cannot be in


@functools.lru_cache(maxsize=None)
def trellis_tables():
    """next_state (8,2), out_sys (8,2), out_par (8,2); state packed as
    (s0<<2)|(s1<<1)|s2 with s0 the most recent feedback bit."""
    next_state = np.zeros((8, 2), np.int32)
    out_sys = np.zeros((8, 2), np.int32)
    out_par = np.zeros((8, 2), np.int32)
    for state in range(8):
        s0, s1, s2 = (state >> 2) & 1, (state >> 1) & 1, state & 1
        for bit in range(2):
            fb = (bit + s1 + s2) % 2
            out_sys[state, bit] = fb           # the quirk: sys = feedback
            out_par[state, bit] = (fb + s0 + s2) % 2
            next_state[state, bit] = (fb << 2) | (s0 << 1) | s1
    return next_state, out_sys, out_par


@functools.lru_cache(maxsize=None)
def reverse_trellis():
    """prev_state (8,2), prev_input (8,2): the two incoming edges per state."""
    next_state, _, _ = trellis_tables()
    prev_state = np.zeros((8, 2), np.int32)
    prev_input = np.zeros((8, 2), np.int32)
    count = np.zeros(8, np.int32)
    for s in range(8):
        for b in range(2):
            ns = next_state[s, b]
            prev_state[ns, count[ns]] = s
            prev_input[ns, count[ns]] = b
            count[ns] += 1
    assert np.all(count == 2)
    return prev_state, prev_input


def branch_metrics(l_sys: torch.Tensor, l_par: torch.Tensor,
                   l_apr: torch.Tensor) -> torch.Tensor:
    """γ (..., K', 8, 2) = (L_sys·sys_sign + L_par·par_sign + L_apr·in_sign)·0.5,
    added in that order; a sign is +1 for a 0 bit."""
    _, sys_t, par_t = trellis_tables()
    dev = l_sys.device
    sys_sign = torch.tensor(1.0 - 2.0 * sys_t, dtype=torch.float32, device=dev)
    par_sign = torch.tensor(1.0 - 2.0 * par_t, dtype=torch.float32, device=dev)
    in_sign = torch.tensor([1.0, -1.0], dtype=torch.float32, device=dev)
    return (l_sys[..., None, None] * sys_sign + l_par[..., None, None] * par_sign
            + l_apr[..., None, None] * in_sign) * 0.5


def _reduce(x: torch.Tensor, use_max_log: bool) -> torch.Tensor:
    """The semiring's sum over the last axis: max, or log-sum-exp."""
    return x.amax(dim=-1) if use_max_log else torch.logsumexp(x, dim=-1)


def bcjr_plain(l_sys: torch.Tensor, l_par: torch.Tensor, l_apr: torch.Tensor,
               use_max_log: bool = True) -> torch.Tensor:
    """The a-posteriori LLRs (..., K') of one BCJR pass, in plain PyTorch: α
    forward from state 0 and β backward from state 0 at K' with the JAX
    "scan" form's per-step arithmetic, one loop over the K' steps carrying
    both (step j of α beside step K'−1−j of β, so a step is three ops for
    the two), then APP_k = ⊕_s(α_k[s] + γ_k[s,0] + β_{k+1}[ns(s,0)]) −
    ⊕_s(… input 1)."""
    ns_t, _, _ = trellis_tables()
    ps_t, pi_t = reverse_trellis()
    dev = l_sys.device
    lead, kp = tuple(l_sys.shape[:-1]), l_sys.shape[-1]
    g = branch_metrics(l_sys, l_par, l_apr).reshape((-1, kp, 8, 2))
    n = g.shape[0]
    ps = torch.as_tensor(ps_t.reshape(-1), dtype=torch.int64, device=dev)
    pi = torch.as_tensor(pi_t.reshape(-1), dtype=torch.int64, device=dev)
    ns = torch.as_tensor(ns_t.reshape(-1), dtype=torch.int64, device=dev)
    # γ of the edges into s' (α) beside those out of s (β, steps reversed),
    # one contiguous (2, n, 16) slab a step; the states they start from
    g2 = torch.stack((g[:, :, ps, pi], g.reshape(n, kp, 16).flip(1)))
    g2 = g2.permute(2, 0, 1, 3).contiguous().unbind(0)
    src = torch.stack((ps, ns))[:, None, :].expand(2, n, 16)

    m = torch.empty((kp + 1, 2, n, 8), dtype=torch.float32, device=dev)
    m[0] = NEG
    m[0, :, :, 0] = 0.0
    for j in range(kp):
        x = m[j].gather(2, src).add_(g2[j]).view(2, n, 8, 2)
        if use_max_log:
            torch.amax(x, dim=-1, out=m[j + 1])
        else:
            torch.logsumexp(x, dim=-1, out=m[j + 1])
    alphas = m[:kp, 0].transpose(0, 1)                       # α before step k
    betas = m[:kp, 1].flip(0).transpose(0, 1)                # β after step k
    bnext = betas.index_select(2, ns).view(n, kp, 8, 2)
    val = alphas[..., None] + g + bnext
    app = _reduce(val[..., 0], use_max_log) - _reduce(val[..., 1], use_max_log)
    return app.reshape(lead + (kp,))


def bcjr_half_plain(l_sys: torch.Tensor, l_par: torch.Tensor,
                    ext_in: Optional[torch.Tensor], index: Optional[torch.Tensor],
                    hard: bool = False, use_max_log: bool = True) -> torch.Tensor:
    """One half-iteration of the turbo decoder in plain PyTorch, as the JAX
    package's decoder does it: the a-priori plane cat(ext_in[index], 0³)
    (zeros when ext_in is None), `bcjr_plain`, then (APP − a-priori −
    L_sys)[..., :K] float32 step-major (K, ...), or with `hard` (APP <
    0)[..., :K] int32 (..., K). ext_in is step-major (K, ...)."""
    lead, K = tuple(l_sys.shape[:-1]), l_sys.shape[-1] - 3
    if ext_in is None:
        body = l_sys.new_zeros(lead + (K,))
    else:
        body = (ext_in if index is None else torch.index_select(ext_in, 0, index)).movedim(0, -1)
    apr = torch.cat([body, l_sys.new_zeros(lead + (3,))], dim=-1)
    app = bcjr_plain(l_sys, l_par, apr, use_max_log)
    if hard:
        return (app[..., :K] < 0).to(torch.int32)
    return (app - apr - l_sys)[..., :K].movedim(-1, 0).contiguous()


def _check(name: str, tensors, shape: tuple, device: torch.device) -> None:
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"{name}: LLRs must be float32, got {t.dtype}")
        if t.shape != shape or t.device != device:
            raise ValueError(f"{name}: LLRs {tuple(t.shape)} on {t.device}, expected "
                             f"{shape} on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: the kernel reads contiguous LLR planes")


def _launch(name: str, l_sys, l_par, l_apr, index, n_apr: int, out: torch.Tensor,
            mode: int, use_max_log: bool) -> bool:
    """One launch of turbo_bcjr over the (n_blocks, K') planes, none for no
    block (returns whether it launched); raises if it is refused."""
    dev = l_sys.device
    kp = l_sys.shape[-1]
    n = l_sys.numel() // kp
    if n >= 2 ** 31 or kp >= 2 ** 31:
        raise ValueError(f"{name}: a dimension exceeds int32")
    if n == 0:
        return False
    scratch = torch.empty((n, kp, 8), dtype=torch.float32, device=dev)   # α and β
    from .._build import library
    lib = library()
    ptr = (lambda t: None if t is None else t.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.turbo_bcjr(l_sys.data_ptr(), l_par.data_ptr(), ptr(l_apr), ptr(index), n_apr,
                            out.data_ptr(), scratch.data_ptr(), n, kp, mode,
                            int(bool(use_max_log)), stream)
    if rc != 0:
        raise RuntimeError(f"turbo_bcjr launch failed: CUDA error {rc} "
                           f"(n_blocks={n}, K'={kp}, mode {mode})")
    return True


def bcjr_app(l_sys: torch.Tensor, l_par: torch.Tensor, l_apr: torch.Tensor,
             use_max_log: bool = True) -> torch.Tensor:
    """A-posteriori LLRs (..., K') of one BCJR pass over every code block of
    the batch: `bcjr_plain` on a CPU tensor, the `turbo_bcjr` kernel on a
    CUDA tensor (one launch, on the current stream)."""
    dev = l_sys.device
    if dev.type == "cpu":
        return bcjr_plain(l_sys, l_par, l_apr, use_max_log)
    if dev.type != "cuda":
        raise ValueError(f"bcjr_app: no kernel for device {dev}")
    if l_sys.ndim < 1 or l_sys.shape[-1] < 1:
        raise ValueError(f"bcjr_app: no trellis steps in {tuple(l_sys.shape)}")
    _check("bcjr_app", (l_sys, l_par, l_apr), l_sys.shape, dev)
    app = torch.empty_like(l_sys)
    if _launch("bcjr_app", l_sys, l_par, l_apr, None, l_sys.shape[-1], app, 0, use_max_log):
        bcjr_app.launches += 1
    return app


def bcjr_half(l_sys: torch.Tensor, l_par: torch.Tensor, ext_in: Optional[torch.Tensor],
              index: Optional[torch.Tensor], hard: bool = False,
              use_max_log: bool = True) -> torch.Tensor:
    """One half-iteration of the turbo decoder over every code block: from
    L_sys, L_par (..., K') and the other decoder's extrinsic ext_in (K, ...)
    (step-major; None: the first iteration's zeros) read through `index`
    (K,) (a permutation of range(K), int32 on a card; None: in order), the
    extrinsic (K, ...) float32, or with `hard` the bits (..., K) int32:
    `bcjr_half_plain` on a CPU tensor, one launch of `turbo_bcjr` on a CUDA
    tensor."""
    dev = l_sys.device
    if dev.type == "cpu":
        return bcjr_half_plain(l_sys, l_par, ext_in, index, hard, use_max_log)
    if dev.type != "cuda":
        raise ValueError(f"bcjr_half: no kernel for device {dev}")
    if l_sys.ndim < 1 or l_sys.shape[-1] < 4:
        raise ValueError(f"bcjr_half: K' = K + 3 steps with K > 0, got {tuple(l_sys.shape)}")
    _check("bcjr_half", (l_sys, l_par), l_sys.shape, dev)
    lead, K = tuple(l_sys.shape[:-1]), l_sys.shape[-1] - 3
    if ext_in is not None:
        _check("bcjr_half", (ext_in,), (K,) + lead, dev)
    if index is not None:
        if index.dtype != torch.int32:
            raise TypeError(f"bcjr_half: the kernel reads an int32 index, got {index.dtype}")
        if index.shape != (K,) or index.device != dev or not index.is_contiguous():
            raise ValueError(f"bcjr_half: index {tuple(index.shape)} on {index.device}, "
                             f"expected ({K},) on {dev}, contiguous")
    out = torch.empty(lead + (K,), dtype=torch.int32, device=dev) if hard else \
        torch.empty((K,) + lead, dtype=torch.float32, device=dev)
    if _launch("bcjr_half", l_sys, l_par, ext_in, index if ext_in is not None else None, K,
               out, 2 if hard else 1, use_max_log):
        bcjr_half.launches += 1
    return out


bcjr_app.launches = 0
bcjr_half.launches = 0
