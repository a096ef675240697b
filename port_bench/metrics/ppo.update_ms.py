"""Device ms of the update phase of one PPO update (the epochs x
minibatches of loss, gradients, clip and Adam): the median over the traced
window's updates of the CUDA events of `TrainStep.run(..., marks=)`."""

import statistics


def read(layers):
    phases = layers.get('phase_ms')
    return statistics.median(p[2] for p in phases) if phases else None
