"""The yardstick's arithmetic: the peaks of the chip, the operations and
bytes that the work of a cell needs, computed from its shapes, and the
statistics the end-to-end metrics take.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit:
float32 outside the tensor cores 67 TFLOP/s (the networks run in float32
with TF32 refused), HBM3 3.35 TB/s.
"""

from __future__ import annotations

PEAK_FP32_FLOPS = 67e12
PEAK_HBM_BYTES_PER_S = 3.35e12

# operations per env step of the fused rollout: the cost model of the
# TPU kernel it was ported from (counts the same work whatever implements
# it: the Euler step, the status machine, the shaping, the hashed reset)
OPS_PER_ENV_STEP = 158

# words of 4 bytes per env that the fused rollout reads once and writes
# once: in x 12, perturb 6, status, ticks, steps, prev_shaping, episode,
# env id; the constant action's five Eq. 6 terms; out x 12, perturb 6,
# status, ticks, steps, prev_shaping, episode, reward sum, episode count
FUSED_WORDS_PER_ENV = (12 + 6 + 6) + 5 + (12 + 6 + 5 + 2)


def mlp_forward_flops(obs: int, hidden: int, actions: int) -> int:
    """Multiply-adds x 2 of the actor (obs -> h -> h -> actions) and the
    critic (obs -> h -> h -> 1) for one sample."""
    return 2 * ((obs * hidden + hidden * hidden + hidden * actions)
                + (obs * hidden + hidden * hidden + hidden * 1))


def ppo_update_flops(obs: int, hidden: int, actions: int, num_envs: int,
                     rollout: int, epochs: int) -> int:
    """The FLOPs of one PPO update: the networks forward on every
    transition of the rollout, forward and backward (twice the forward)
    on every transition in each epoch, and OPS_PER_ENV_STEP per env
    step."""
    n = num_envs * rollout
    fwd = mlp_forward_flops(obs, hidden, actions)
    return fwd * n + 3 * fwd * n * epochs + OPS_PER_ENV_STEP * n


def fused_bound_s(num_envs: int, steps: int) -> float:
    """The least time the chip could take for one fused rollout call: the
    larger of its operations over the float32 peak and its bytes, each
    read and written once, over the memory bandwidth."""
    ops = OPS_PER_ENV_STEP * num_envs * steps
    nbytes = 4 * FUSED_WORDS_PER_ENV * num_envs
    return max(ops / PEAK_FP32_FLOPS, nbytes / PEAK_HBM_BYTES_PER_S)


def percentile(values, q: float) -> float:
    """The q-th percentile (0 < q < 100) of the values by linear
    interpolation between closest ranks (numpy's default method)."""
    xs = sorted(values)
    if not xs:
        raise ValueError('no values')
    pos = (len(xs) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(xs) - 1)
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def rate(units: int, per_unit: float, seconds: float) -> float:
    """Work per second: `units` of `per_unit` each over `seconds`."""
    if seconds <= 0:
        raise ValueError(f'a rate over {seconds} s')
    return units * per_unit / seconds

