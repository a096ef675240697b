"""The fused rollout's whole share of the chip's float32 peak in its
unprofiled window: 158 operations per env step of the calls completed in
the window, over the window's host seconds, against 67 TFLOP/s.  It
bounds `fused_rollout_roofline` from below while the calls' work stays
in the kernel, and stays when the kernel's own reading does not."""

from port_bench.reference import counts


def read(layers):
    if layers.get('loop') != 'fused' or not layers.get('window_s'):
        return None
    ops = counts.OPS_PER_ENV_STEP * layers['env_steps_per_call'] \
        * layers['window_calls']
    return 100.0 * ops / layers['window_s'] / counts.PEAK_FP32_FLOPS
