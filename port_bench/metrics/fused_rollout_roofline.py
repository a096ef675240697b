"""The fused rollout kernel's share of its roofline: the least time the
chip could take for one call (the larger of 158 operations per env step
over the float32 peak and the state's bytes, each read and written once,
over the memory bandwidth; reference/counts.py `fused_bound_s`) over the
kernel's device time per call in the trace."""


def read(layers):
    kernel_s = layers.get('kernel_s')
    if not kernel_s:
        return None
    return 100.0 * layers['bound_s'] / (kernel_s / layers['kernel_calls'])
