"""The device's idle share in % of the traced run's unprofiled window of
the PPO train step: 100 x (1 - device seconds / host seconds), the
device seconds the sum over the window's updates of the CUDA events of
`TrainStep.run(..., marks=)` from the rollout's start to the update's
end, the host seconds those from the window's start to the last update's
read.  What lies between an update's end and the next one's start (the
host's read and launch) is idle; a gap inside a phase is not seen."""


def read(layers):
    phases, window_s = layers.get('phase_ms'), layers.get('window_s')
    if layers.get('loop') != 'train' or not phases or not window_s:
        return None
    busy_s = sum(sum(p) for p in phases) * 1e-3
    return 100.0 * (1.0 - busy_s / window_s)
