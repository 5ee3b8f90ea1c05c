"""The benchmark harness of ofdm_lte_tpu_torch: the runner, the input
generator, the trace reduction, the work arithmetic and the comparison
that decides `correct`. Nothing here imports JAX or the JAX package."""
