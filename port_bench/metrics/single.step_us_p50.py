"""The median latency in µs of the window's B = 1 `step()` calls, from
the call to the numpy observation in hand."""

import statistics


def read(layers):
    steps = layers.get('step_us')
    return statistics.median(steps) if steps else None
