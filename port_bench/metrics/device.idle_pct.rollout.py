"""The device's idle share in % of the fused rollout's unprofiled window:
100 x (1 - device seconds per call / host seconds per call), the device
seconds the busy seconds of the profiled calls (the union of their
kernel, copy and fill intervals in the trace) over their number, the
host seconds the window's over its calls."""


def read(layers):
    profile = layers.get('profile')
    if layers.get('loop') != 'fused' or not profile:
        return None
    busy = profile['busy_s'] / layers['kernel_calls']
    return 100.0 * (1.0 - busy * layers['window_calls'] / layers['window_s'])
