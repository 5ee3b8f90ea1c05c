"""Published peaks of one NVIDIA H100 SXM at its 700 W power limit (NVIDIA's
data sheet, dense rates without sparsity). Every roofline and `mfu` share
of the benchmark divides by these, whatever the card's own power limit,
which a traced run prints beside them."""

H100_SXM = {
    "bf16_dense_flops": 989e12,   # the highest rate for 16-bit or wider inputs
    "tf32_dense_flops": 495e12,
    "fp32_flops": 67e12,          # CUDA cores, outside the tensor cores
    "hbm_bytes_per_s": 3.35e12,
}
