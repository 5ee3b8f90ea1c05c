"""Process-level matmul-precision policy for the modem's complex GEMMs.

Selected by the environment variable

    OFDM_LTE_TPU_TORCH_MATMUL_PRECISION = highest | high | default

and read at each call. The names are the JAX package's, and each is what it
is on this card: `highest` is a product as accurate as fp32 with fp32
accumulation (three TF32 products per fp32 product on the tensor cores);
`high` is one TF32 product of the operands rounded to TF32; `default` is
bf16 operands with fp32 accumulation. The complex-GEMM kernels
(ops/cmatmul.py) implement all three on the tensor cores, in both forms.
On the CPU the knob is inert, as in the JAX package: a CPU product is true
fp32 at every level.

The port's default is `highest` until the H100 benchmark's cells (ROADMAP
A8) pick another; the JAX package's TPU precision study does not carry
over.
"""
from __future__ import annotations

import os

_LEVELS = ("highest", "high", "default")


def matmul_precision_name() -> str:
    """Current policy name (the environment is re-read on each call)."""
    name = os.environ.get("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "highest").lower()
    if name not in _LEVELS:
        raise ValueError(
            f"OFDM_LTE_TPU_TORCH_MATMUL_PRECISION={name!r}; pick from {list(_LEVELS)}")
    return name
