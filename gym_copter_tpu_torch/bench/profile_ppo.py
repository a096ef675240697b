"""Phase breakdown of the PPO train step on the card, the counterpart of
`scripts/profile_ppo.py`.

    python -m gym_copter_tpu_torch.bench.profile_ppo [--envs 4096] \\
        [--hidden 128] [--rollout 128] \\
        [--out docs/torch_bench_profile_ppo.json]

Times, with `profiling.timeit` (the JAX script's per-call differential)
after back-to-back calls of each item until the card's µs per graph node
is back at its floor (`common.timed`, as train.py; the card's µs per
graph node and nvidia-smi's readings beside each rep),
at the production recipe (minibatches and shuffle block resolved for the
batch: 16 and 128 at 4096 envs):

  * the full graphed train step;
  * the rollout alone (`common.PolicyRollout`, a one-step graph replayed);
  * the update phase alone on synthetic flat data (normals under
    PRNGKey(3)), as an autograd update of the JAX script's loss in three
    shuffle modes: `gather` (a per-element permutation, each minibatch
    gathered by its slice of it), `preshuffle` (the data permuted once per
    epoch, contiguous minibatch slices) and `none` (contiguous slices of
    the unshuffled data, the lower bound); each a CUDA graph on the card;
  * the full step with `matmul_dtype='bfloat16'` (bf16 operands, float32
    products);
  * the analytic FLOPs of the update (the JAX script's formula: forward
    actor and critic dots, backward twice the forward) over the measured
    update time (full step minus rollout), as shares of the H100 SXM5's
    published dense peaks (`mfu_fraction_of_h100_*`).  The port's float32
    products refuse TF32 and its bf16 path multiplies in float32, so the
    fp32 peak is the ceiling of both paths; the bf16 tensor-core peak is
    the card's dense maximum.

Runs on the card only.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from gym_copter_tpu_torch.bench import common
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.learn import optim, ppo

# NVIDIA H100 SXM5 datasheet, dense (no sparsity): BF16 tensor core and
# FP32 outside the tensor cores, at the full 700 W power limit
H100_BF16_DENSE_PEAK = 989.4e12
H100_FP32_PEAK = 66.9e12
PEAK_SOURCE = ('NVIDIA H100 SXM5 datasheet: 989.4 TFLOP/s BF16 tensor core '
               'dense (1,979 with sparsity), 66.9 TFLOP/s FP32; at 700 W')
MODES = ('gather', 'preshuffle', 'none')


def update_flops(obs_size: int, hidden: int, action_size: int, n: int,
                 epochs: int) -> int:
    """The JAX script's analytic FLOPs of the update: per transition and
    epoch the forward actor and critic dots (2 * in * out each) and a
    backward of twice the forward; the elementwise work is left out."""
    h, o, a = hidden, obs_size, action_size
    fwd_flops = 2 * ((o * h + h * h + h * a) + (o * h + h * h + h * 1))
    return 3 * fwd_flops * n * epochs


def synthetic_flat(obs_size: int, action_size: int, n: int, device,
                   dtype=torch.float32):
    """The JAX script's synthetic rollout: (obs, action, old_log_prob,
    old_value, advantage, target), normals under split(PRNGKey(3), 6)."""
    keys = prng.split(prng.PRNGKey(3, device), 6)
    shapes = ((obs_size, n), (action_size, n)) + ((n,),) * 4
    return [prng.normal(k, s, dtype) for k, s in zip(keys, shapes)]


def make_update(mode: str, cfg: ppo.PPOConfig, optimizer: optim.ClipAdam):
    """The JAX script's `make_update(gather_mode)`: cfg.epochs epochs of
    cfg.minibatches Adam steps on its loss (clipped surrogate on normalized
    advantages plus value_coef times the value loss), the minibatches
    chosen by `mode`.  update(leaves, opt_state, key, flat) -> (leaves,
    opt_state)."""
    if mode not in MODES:
        raise ValueError(f'mode must be one of {MODES}, got {mode!r}')

    def loss_fn(leaves, o, a, lp, v, ad, tg):
        mean, log_std, value = ppo._policy(leaves, o, cfg)
        log_prob = ppo._log_prob(mean, log_std, a)
        ratio = torch.exp(log_prob - lp)
        adn = (ad - ad.mean()) / (ad.std(correction=0) + 1e-8)
        pg = -torch.mean(torch.minimum(
            ratio * adn,
            torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adn))
        vl = 0.5 * torch.mean((value - tg) ** 2)
        return pg + cfg.value_coef * vl

    def update(leaves, opt_state, key, flat):
        n = flat[0].shape[-1]
        mb = n // cfg.minibatches
        for _ in range(cfg.epochs):
            key, sub = prng.split(key)
            data = flat
            if mode != 'none':
                perm = prng.permutation(sub, n)
            if mode == 'preshuffle':
                data = [x.index_select(-1, perm) for x in flat]
            for i in range(cfg.minibatches):
                if mode == 'gather':
                    idx = perm[i * mb:(i + 1) * mb]
                    batch = [x.index_select(-1, idx) for x in data]
                else:
                    batch = [x[..., i * mb:(i + 1) * mb] for x in data]
                with torch.enable_grad():
                    req = [p.detach().requires_grad_() for p in leaves]
                    grads = torch.autograd.grad(loss_fn(req, *batch), req)
                updates, opt_state = optimizer.update(list(grads), opt_state)
                leaves = optim.apply_updates(leaves, updates)
        return leaves, opt_state

    return update


def _full_step(params, spec, cfg, b, device, state, timing):
    env_ids = torch.arange(b, dtype=torch.int32, device=device)
    step, opt = ppo.make_train_step(params, spec, cfg,
                                    prng.PRNGKey(1, device), env_ids)
    ts = ppo.init_train_state(prng.PRNGKey(0, device), params, spec, cfg, b,
                              opt)

    def run(n):
        t = ts
        for _ in range(n):
            t, m = step(t)
        float(m['reward_per_step'])

    return common.timed(run, state, **timing), ts


def measure(envs: int = 4096, hidden: int = 128, rollout: int = 128, *,
            device=None, reps: int = 8, n_lo: int = 3, n_hi: int = 13,
            warmup: tuple = common.WARMUP) -> dict:
    """The profile's record (see the module docstring); on the card unless
    device='cpu'."""
    device = resolve_device(device)
    state = common.card_state(device)  # its floor read before captures
    timing = dict(reps=reps, n_lo=n_lo, n_hi=n_hi, warmup=warmup)
    b, t = envs, rollout
    params, spec, _, _, _, _ = common.lander_batch(b, device)
    cfg = ppo.resolve_minibatches(
        ppo.PPOConfig(rollout_steps=t, hidden=hidden), b)
    key = prng.PRNGKey(0, device)
    results = {'backend': device.type, 'envs': b, 'rollout': t,
               'hidden': hidden, 'epochs': cfg.epochs,
               'minibatches': cfg.minibatches,
               'shuffle_block': cfg.shuffle_block,
               'card': common.card_record(device),
               'torch': torch.__version__, 'timing': timing, 'card_beside': {},
               'warm_up': {}}

    def record(name, res):
        results[name] = res['seconds']
        results['card_beside'][name] = res['beside']
        results['warm_up'][name] = res['warm_up']

    # ---- full step ----
    res, ts = _full_step(params, spec, cfg, b, device, state, timing)
    record('full_step_s', res)
    net = ts.params

    # ---- rollout only ----
    env_ids = torch.arange(b, dtype=torch.int32, device=device)
    rollout_only = common.PolicyRollout(params, spec, cfg,
                                        prng.PRNGKey(1, device), env_ids, t)
    leaves = net.leaves()

    def run_rollout(n):
        for i in range(n):
            r = rollout_only(leaves, ts.env_state, prng.fold_in(key, i))
        float(r)

    record('rollout_s', common.timed(run_rollout, state, **timing))

    # ---- the update phase alone, on synthetic flat data ----
    n = t * b
    flat = synthetic_flat(spec.obs_size, spec.action_size, n, device)
    optimizer = optim.ClipAdam(cfg.max_grad_norm, cfg.learning_rate)
    opt_state = optimizer.init(leaves)
    for mode in MODES:
        upd = make_update(mode, cfg, optimizer)
        graph = Graph(upd, warmup=3) if device.type == 'cuda' else None

        def run_upd(n_calls, upd=upd, graph=graph):
            for i in range(n_calls):
                k = prng.fold_in(key, i)
                if graph is None:
                    out = upd(leaves, opt_state, k, flat)
                else:
                    # after the capture, the data is the graph's own buffer
                    data = flat if graph.graph is None else graph.inputs[3]
                    out = graph(leaves, opt_state, k, data)
            float(out[0][-1][0])

        record(f'update_{mode}_s', common.timed(run_upd, state, **timing))
        del graph

    # ---- the bf16-operand variant of the full step ----
    res, _ = _full_step(params, spec, cfg._replace(matmul_dtype='bfloat16'),
                        b, device, state, timing)
    record('full_step_bf16_s', res)

    # ---- analytic FLOP accounting of the update phase ----
    flops = update_flops(spec.obs_size, hidden, spec.action_size, n,
                         cfg.epochs)
    update_actual = results['full_step_s'] - results['rollout_s']
    results['mfu'] = {'update_flops_analytic': flops,
                      'peak_source': PEAK_SOURCE,
                      'note': ('analytic dot FLOPs only, over the update '
                               'time full_step_s - rollout_s; the float32 '
                               'products run outside the tensor cores')}
    if update_actual > 1e-4:
        achieved = flops / update_actual
        results['mfu'].update({
            'achieved_flops_per_sec': achieved,
            'mfu_fraction_of_h100_bf16_dense_peak':
                achieved / H100_BF16_DENSE_PEAK,
            'mfu_fraction_of_h100_fp32_peak': achieved / H100_FP32_PEAK,
        })
    results['accounting'] = {
        'rollout_pct': 100 * results['rollout_s'] / results['full_step_s'],
        'update_actual_s': update_actual,
        'update_pct': 100 * update_actual / results['full_step_s'],
    }
    if update_actual > 1e-4:
        results['accounting'].update({
            'element_gather_vs_actual':
                results['update_gather_s'] / update_actual,
            'unshuffled_lower_bound_vs_actual':
                results['update_none_s'] / update_actual,
        })
    else:
        # full_step_s and rollout_s are timed apart: a difference of ~0 is
        # noise, and the ratios over it would be too
        results['accounting']['ratios_skipped'] = (
            'update_actual <= 0.1 ms — subtraction of independently timed '
            'quantities is noise-dominated at this scale')
    results['card_after'] = common.card_record(device)
    return results


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument('--envs', type=int, default=4096)
    p.add_argument('--hidden', type=int, default=128)
    p.add_argument('--rollout', type=int, default=128)
    p.add_argument('--out', default=str(common.DOCS
                                        / 'torch_bench_profile_ppo.json'))
    args = p.parse_args(argv)
    results = measure(args.envs, args.hidden, args.rollout)
    print(json.dumps(results, indent=1))
    common.write_json(args.out, results)
    return 0


if __name__ == '__main__':
    sys.exit(main())
