"""Process-level matmul-precision policy for the modem's complex GEMMs.

Selected by the environment variable

    OFDM_LTE_TPU_TORCH_MATMUL_PRECISION = highest | high | default

and read at each call. `highest` is IEEE fp32 products with fp32
accumulation; `high` (TF32) and `default` (bf16 operands, fp32
accumulation) name the tensor-core forms. The complex-GEMM kernel
(ops/cmatmul.py) implements `highest` only and raises NotImplementedError
for the other two on a CUDA tensor. On the CPU the knob is inert, as in
the JAX package.

The port's default is `highest` until a BER study on the H100 picks
another; the JAX package's TPU precision study does not carry over.
"""
from __future__ import annotations

import os

# policy name -> torch.set_float32_matmul_precision name
_LEVELS = {
    "highest": "highest",
    "high": "high",
    "default": "medium",
}


def matmul_precision_name() -> str:
    """Current policy name (the environment is re-read on each call)."""
    name = os.environ.get("OFDM_LTE_TPU_TORCH_MATMUL_PRECISION", "highest").lower()
    if name not in _LEVELS:
        raise ValueError(
            f"OFDM_LTE_TPU_TORCH_MATMUL_PRECISION={name!r}; pick from {list(_LEVELS)}")
    return name


def matmul_precision() -> str:
    """Current policy as a torch float32 matmul precision name."""
    return _LEVELS[matmul_precision_name()]
