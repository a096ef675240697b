"""Device ms of the rollout phase of one PPO update: the median over the
traced window's updates of the CUDA events that `TrainStep.run(...,
marks=)` records before the rollout and after it."""

import statistics


def read(layers):
    phases = layers.get('phase_ms')
    return statistics.median(p[0] for p in phases) if phases else None
