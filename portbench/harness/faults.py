"""Faults planted under the HARQ entry's timed path, to show that the
comparison which decides `correct` catches them (control.py --faults, and
the CPU tests). `plant(name)` patches ofdm_lte_tpu_torch.sim.coded.CodedLink
in this process and returns the function that takes the patch out:

- `stale`: the HARQ call returns the first results it made after the
  plant, whatever its inputs (a step that returns its state unchanged);
- `half`: the first half of the lanes run, their results stand in for the
  other half (half of the batch left out);
- `answer`: the last lane's kept decode has one bit altered before its
  errors are counted (an answer altered where it is produced);
- `crc`: the first lane's CRC-24A outcome is inverted at every stage,
  where the check produces it.

The benchmark's own runs never import this module.
"""
from __future__ import annotations


def plant(name: str):
    import torch
    from ofdm_lte_tpu_torch.sim import coded
    cls = coded.CodedLink
    attr = {"stale": "harq", "half": "harq", "answer": "_errors", "crc": "check"}[name]
    orig = getattr(cls, attr)

    if name == "stale":
        first = []

        def patched(self, *a, **k):
            r = orig(self, *a, **k)
            if not first:
                first.append(r)
            return first[0]
    elif name == "half":
        def patched(self, bits, snr_db, rv_sequence=(0, 1, 2, 3), num_iterations=8,
                    use_max_log=None, generator=None, draws=None):
            n = bits.shape[0] // 2
            cut = {"noise": tuple(x[:, :n] for x in draws["noise"])}
            r = orig(self, bits[:n], snr_db[:n], rv_sequence, num_iterations, use_max_log,
                     generator, cut)
            return type(r)(*(torch.cat([x, x]) for x in r))
    elif name == "answer":
        def patched(self, bits_rx, bits):
            bits_rx = bits_rx.clone()
            bits_rx[-1, 0] ^= 1
            return orig(self, bits_rx, bits)
    else:
        def patched(self, tb_rx):
            passed = orig(self, tb_rx).clone()
            passed[0] = ~passed[0]
            return passed

    setattr(cls, attr, patched)

    def undo():
        setattr(cls, attr, orig)
    return undo
