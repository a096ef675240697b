"""Host µs of one `fused_rollout` call, from the call to its return (the
launch is asynchronous; nothing synchronizes inside it): the median over
the window's calls."""

import statistics


def read(layers):
    host = layers.get('host_us_per_call')
    return statistics.median(host) if host else None
