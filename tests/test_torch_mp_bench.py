"""The scaling measurement (parallel.mp_bench.measure,
distributed.scaling_efficiency) on the CPU: the JAX package's keys with
positive rates at 1 and 2 processes. Its worker pins each process to a
core; rates on the CPU are no device metric, and tier-1 holds no threshold
on them."""
import os

import pytest
import torch

from ofdm_lte_tpu_torch import LTEConfig
from ofdm_lte_tpu_torch.parallel import distributed, mp_bench

torch.set_num_threads(2)


def test_measure_has_the_jax_keys_and_positive_rates():
    r = mp_bench.measure((1, 2), frames=2, n_steps=2, retries=1, device="cpu")
    assert list(r) == [1, 2]
    for n, v in r.items():
        assert set(v) == {"per_process", "rates", "total", "efficiency"}
        assert len(v["rates"]) == n and all(x > 0 for x in v["rates"])
        assert v["per_process"] == min(v["rates"]) and v["total"] == pytest.approx(sum(v["rates"]))
    assert r[1]["efficiency"] == 1.0 and r[2]["efficiency"] > 0


def test_scaling_efficiency_has_the_jax_keys():
    r = distributed.scaling_efficiency(LTEConfig(1.25, modulation="QPSK"), (1, 2),
                                       frames_per_device=2, n_steps=1, device="cpu")
    assert list(r) == [1, 2]
    for v in r.values():
        assert set(v) == {"frames_per_s", "per_device", "efficiency"}
        assert v["frames_per_s"] > 0 and v["per_device"] > 0
    assert r[1]["efficiency"] == 1.0


def test_a_failing_worker_raises_and_is_reaped():
    with pytest.raises(RuntimeError, match="failed"):
        mp_bench.spawn(2, [{"job": "nope"}], "cpu", timeout_s=120)
    with pytest.raises(RuntimeError, match="did not finish"):
        mp_bench.spawn(1, [{"job": "bench", "link": "flagship", "frames": 64,
                            "n_steps": 50}], "cpu", timeout_s=3)


# the slow lane, as the JAX package's test_multiprocess_scaling_efficiency:
# test_measure_has_the_jax_keys_and_positive_rates keeps the default guard
@pytest.mark.slow
def test_multiprocess_scaling_efficiency():
    """Two core-pinned processes each keep >= 85% of one process's rate."""
    if (os.cpu_count() or 1) < 2:
        pytest.skip("needs two cores")
    r = mp_bench.measure((1, 2), frames=64, device="cpu")
    assert r[2]["efficiency"] >= 0.85, r
