"""The device's idle share in % of the B = 1 step's unprofiled window:
100 x (1 - device seconds per step / host seconds per step), the device
seconds the busy seconds of the profiled steps (the union of their
kernel, copy and fill intervals in the trace) over their number, the
host seconds the window's over its steps (the resets among them
included on both sides)."""


def read(layers):
    profile = layers.get('profile')
    if layers.get('loop') != 'single' or not profile:
        return None
    busy = profile['busy_s'] / layers['traced_steps']
    return 100.0 * (1.0 - busy * layers['window_steps'] / layers['window_s'])
