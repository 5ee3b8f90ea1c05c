"""One BCJR pass over a batch of terminated code blocks: the CUDA kernel's
wrapper and its plain version.

The turbo decoder's constituent pass (coding/turbo._bcjr): from the
systematic, parity and a-priori LLRs of K' = K + 3 trellis steps, the
a-posteriori LLRs of every step, with the trellis started and ended in
state 0. The JAX package runs it as two lax.scans
(ofdm_lte_tpu/coding/turbo.py:424-448, its "scan" form); eager PyTorch would
make that a Python loop of some 10 launches a step, about 10^6 a decode,
so on a card one launch does a whole pass for every code block:

- on a CPU tensor `bcjr_app` runs `bcjr_plain`, a loop over the K' steps
  that repeats the "scan" form's arithmetic op for op (the form the CPU
  tests compare with the JAX package);
- on a CUDA tensor it launches csrc/turbo_bcjr.cu (`turbo_bcjr`), built on
  first use (_build.py), or raises. It never falls back to the plain
  version. Each launch adds one to `bcjr_app.launches`.

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


def _check(tensors) -> None:
    first = tensors[0]
    for t in tensors:
        if t.dtype != torch.float32:
            raise TypeError(f"bcjr_app: LLRs must be float32, got {t.dtype}")
        if t.shape != first.shape or t.device != first.device:
            raise ValueError(f"bcjr_app: LLRs {tuple(t.shape)} on {t.device} and "
                             f"{tuple(first.shape)} on {first.device}")
        if not t.is_contiguous():
            raise ValueError("bcjr_app: the kernel reads contiguous (n_blocks, K') LLRs")
    if first.ndim < 1 or first.shape[-1] < 1:
        raise ValueError(f"bcjr_app: no trellis steps in {tuple(first.shape)}")


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
    _check((l_sys, l_par, l_apr))
    kp = l_sys.shape[-1]
    n = l_sys.numel() // kp
    if n >= 2 ** 31 or kp >= 2 ** 31:
        raise ValueError("bcjr_app: a dimension exceeds int32")
    app = torch.empty_like(l_sys)
    if n == 0:
        return app
    alpha = torch.empty((n, kp, 8), dtype=torch.float32, device=dev)   # α scratch
    from .._build import library
    lib = library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.turbo_bcjr(l_sys.data_ptr(), l_par.data_ptr(), l_apr.data_ptr(),
                            app.data_ptr(), alpha.data_ptr(), n, kp, int(bool(use_max_log)),
                            stream)
    if rc != 0:
        raise RuntimeError(f"turbo_bcjr launch failed: CUDA error {rc} "
                           f"(n_blocks={n}, K'={kp})")
    bcjr_app.launches += 1
    return app


bcjr_app.launches = 0
