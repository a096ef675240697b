"""The whole train step's share of the chip's float32 peak: the FLOPs of
one update, computed from its shapes (reference/counts.py
`ppo_update_flops`), over the median device time of the traced window's
updates (rollout + GAE + update by the events of `TrainStep.run(...,
marks=)`), against 67 TFLOP/s."""

import statistics

from port_bench.reference import counts


def read(layers):
    phases = layers.get('phase_ms')
    if not phases:
        return None
    step_s = statistics.median(sum(p) for p in phases) * 1e-3
    return 100.0 * layers['flops_per_update'] / step_s \
        / counts.PEAK_FP32_FLOPS
