"""The plain reference of one PPO train step: the rollout of the policy in
the env with its sampled actions and auto-resets, GAE, and epochs x
minibatches of clipped-loss steps through clip-by-global-norm and Adam
with the linearly annealed rate.  Eager torch, features-first (…, B).

A frozen copy of the measured package's eager train step for one device,
in the same operations and operand order, so that on one card it gives
the program's numbers bit for bit; it imports nothing of the program.

`matmul='tf32'` rounds both operands of every product of the networks to
TF32 (10 mantissa bits, to nearest even) and multiplies in float32: the
precision a card drops to when TF32 is allowed, the benchmark's control.
`fault` plants one of the faults the comparison must catch: 'half_batch'
(each minibatch's loss over its first half), 'reward' (one reward of the
first rollout altered where the env produces it).
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from port_bench.reference import env as E
from port_bench.reference import prng

_INT32_MAX = 2 ** 31 - 1


class Recipe(NamedTuple):
    rollout_steps: int
    learning_rate: float
    gamma: float
    gae_lambda: float
    clip_eps: float
    epochs: int
    minibatches: int
    value_coef: float
    entropy_coef: float
    max_grad_norm: float
    hidden: int
    init_log_std: float
    obs_scale: float
    init_action_bias: float
    value_clip: float
    log_std_min: float
    log_std_max: float
    anneal_lr: bool
    anneal_lr_floor: float
    anneal_updates: int
    shuffle_block: int
    target_kl: float


def recipe_from_config(cfg: dict) -> Recipe:
    return Recipe(**cfg['ppo'])


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 values rounded to TF32's 10 mantissa bits, ties to even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0xFFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    """a @ b with both operands rounded to TF32, forward and backward, as
    a card's TF32 products compute it (float32 accumulation)."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return round_tf32(a) @ round_tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        return g @ round_tf32(b).mT, round_tf32(a).mT @ g


def mlp_apply(layers, x, matmul=None):
    for i, (w, b) in enumerate(layers):
        if matmul == 'tf32':
            x = _TF32MatMul.apply(w, x) + b[:, None]
        else:
            dt = torch.promote_types(w.dtype, x.dtype)
            x = w.to(dt) @ x.to(dt) + b[:, None]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def unflatten(leaves):
    n = (len(leaves) - 1) // 2

    def pairs(ts):
        return list(zip(ts[0::2], ts[1::2]))

    return pairs(leaves[:n]), pairs(leaves[n:2 * n]), leaves[-1]


def policy(leaves, obs, r: Recipe, matmul=None):
    """(mean (A, N), clipped log_std (A, 1), value (N,))."""
    actor, critic, log_std = unflatten(leaves)
    x = E.div(obs, r.obs_scale)
    mean = mlp_apply(actor, x, matmul) + r.init_action_bias
    value = mlp_apply(critic, x, matmul)[0]
    return (mean, torch.clamp(log_std, r.log_std_min, r.log_std_max)[:, None],
            value)


def log_prob(mean, log_std, action):
    z = (action - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi),
                     dim=0)


# -- the optimizer: clip by global norm, then Adam, with a linear rate -----

class Adam(NamedTuple):
    count: torch.Tensor
    mu: List[torch.Tensor]
    nu: List[torch.Tensor]
    schedule_count: torch.Tensor


def adam_init(leaves) -> Adam:
    zero = torch.zeros((), dtype=torch.int32, device=leaves[0].device)
    return Adam(count=zero, mu=[torch.zeros_like(p) for p in leaves],
                nu=[torch.zeros_like(p) for p in leaves],
                schedule_count=zero.clone())


def _safe_increment(count):
    return torch.where(count < _INT32_MAX, count + 1, count)


def _fma32(a, b: float, c: float):
    """float32 a * b + c rounded once (round-to-odd float64 sum)."""
    p = a * b
    s = p + c
    t = s - p
    err = (p - (s - t)) + (c - t)
    away = torch.nextafter(s, s + err * 2.0 ** 1000)
    return torch.where((s.view(torch.int64) & 1) == 0, away,
                       s).to(torch.float32)


def linear_rate(r: Recipe):
    """count -> the rate, annealed linearly from learning_rate to
    learning_rate * anneal_lr_floor over every optimizer step of
    `anneal_updates` updates, as two float32 fused multiply-adds."""
    if not r.anneal_lr:
        return None
    steps = r.anneal_updates * r.epochs * r.minibatches
    end = r.learning_rate * r.anneal_lr_floor
    inv = float(np.float32(1.0 / steps))
    d = float(np.float32(r.learning_rate - end))
    e = float(np.float32(end))

    def schedule(count):
        c = torch.clamp(count, 0, steps).to(torch.float64)
        frac = (c * -inv + 1).to(torch.float32).to(torch.float64)
        return _fma32(frac, d, e) if e else (frac * d).to(torch.float32)

    return schedule


def adam_update(grads, state: Adam, r: Recipe, schedule, b1=0.9, b2=0.999,
                eps=1e-8):
    g_norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
    trigger = g_norm < r.max_grad_norm
    n = torch.where(trigger, torch.ones_like(g_norm), g_norm)
    m = torch.where(trigger, torch.ones_like(g_norm),
                    torch.full_like(g_norm, r.max_grad_norm))
    grads = [g / n.to(g.dtype) * m.to(g.dtype) for g in grads]
    mu = [(1 - b1) * g + b1 * t for g, t in zip(grads, state.mu)]
    nu = [(1 - b2) * (g * g) + b2 * t for g, t in zip(grads, state.nu)]
    count = _safe_increment(state.count)
    c = count.to(torch.float64)
    bc1 = 1 - torch.pow(b1, c)
    bc2 = 1 - torch.pow(b2, c)
    updates = [(m_ / bc1.to(m_.dtype)) / (torch.sqrt(v / bc2.to(v.dtype))
                                          + eps)
               for m_, v in zip(mu, nu)]
    if schedule is not None:
        step_size = -1 * schedule(state.schedule_count)
        updates = [step_size.to(u.dtype) * u for u in updates]
        schedule_count = _safe_increment(state.schedule_count)
    else:
        updates = [-r.learning_rate * u for u in updates]
        schedule_count = state.schedule_count
    return updates, Adam(count=count, mu=mu, nu=nu,
                         schedule_count=schedule_count)


def _adam_where(cond, a: Adam, b: Adam) -> Adam:
    def w(x, y):
        return torch.where(cond, x, y)

    return Adam(count=w(a.count, b.count),
                mu=[w(x, y) for x, y in zip(a.mu, b.mu)],
                nu=[w(x, y) for x, y in zip(a.nu, b.nu)],
                schedule_count=w(a.schedule_count, b.schedule_count))


# -- the train step ---------------------------------------------------------

class State(NamedTuple):
    leaves: List[torch.Tensor]
    opt: Adam
    env_state: E.EnvState
    obs: torch.Tensor
    key: torch.Tensor


class TrainStep:
    """One PPO update from a `State`: `step(state) -> (state, metrics)`,
    metrics the stacked (reward_per_step, episode_return_proxy,
    done_rate, pg_loss, v_loss, entropy, approx_kl)."""

    def __init__(self, task: E.Task, r: Recipe, base_key, env_ids,
                 matmul: Optional[str] = None, fault: Optional[str] = None):
        if fault not in (None, 'half_batch', 'reward'):
            raise ValueError(f'unknown fault {fault!r}')
        self.task, self.r, self.base_key, self.env_ids = (task, r, base_key,
                                                          env_ids)
        self.matmul, self.fault = matmul, fault
        self.hover = E.hover_motor_value(task)
        self.schedule = linear_rate(r)
        self.num_envs = int(env_ids.shape[0])
        self.updates = 0

    def rollout(self, leaves, env_state, obs, key):
        r, traj = self.r, []
        with torch.no_grad():
            for t in range(r.rollout_steps):
                key, sub = prng.split(key)
                mean, log_std, value = policy(leaves, obs, r, self.matmul)
                noise = prng.normal(sub, (mean.shape[0], self.num_envs),
                                    mean.dtype)
                action = mean + torch.exp(log_std) * noise
                lp = log_prob(mean, log_std, action)
                env_state, next_obs, reward, done = E.step(
                    env_state, self.hover * (1.0 + action), self.base_key,
                    self.env_ids, self.task)
                if self.fault == 'reward' and self.updates == 0 and t == 0:
                    reward = reward.clone()
                    reward[0] += 1.0
                traj.append((obs, action, lp, value, reward, done))
                obs = next_obs
        return env_state, obs, key, [torch.stack(f) for f in zip(*traj)]

    def advantages(self, leaves, traj, obs):
        r = self.r
        t_obs, t_action, t_lp, t_value, t_reward, t_done = traj
        with torch.no_grad():
            _, _, last_value = policy(leaves, obs, r, self.matmul)
            next_values = torch.cat([t_value[1:], last_value[None]], dim=0)
            nonterminal = 1.0 - t_done.to(torch.float32)
            delta = t_reward + r.gamma * next_values * nonterminal - t_value
            decay = r.gamma * r.gae_lambda * nonterminal
            adv = torch.empty_like(delta)
            gae = torch.zeros_like(last_value)
            for t in reversed(range(delta.shape[0])):
                gae = delta[t] + decay[t] * gae
                adv[t] = gae
            target = adv + t_value
            sums = torch.stack([t_reward.sum(), t_reward.sum(0).sum(),
                                t_done.to(t_reward.dtype).sum()])

            def flat3(x):
                return torch.movedim(x, 1, 0).reshape(x.shape[1], -1)

            flat = (flat3(t_obs), flat3(t_action)) + tuple(
                x.reshape(-1) for x in (t_lp, t_value, adv, target))
            steps = t_reward.shape[0] * self.num_envs
            stats = torch.stack([E.div(sums[0], steps),
                                 E.div(sums[1], self.num_envs),
                                 E.div(sums[2], steps)])
        return flat, stats

    def loss(self, leaves, obs, action, old_lp, old_value, advantage,
             target):
        r = self.r
        n = advantage.shape[-1]
        adv_mean, adv_std = advantage.mean(), advantage.std(correction=0)
        if self.fault == 'half_batch':
            h = n // 2
            obs, action, old_lp, old_value, advantage, target = (
                x[..., :h] for x in (obs, action, old_lp, old_value,
                                     advantage, target))
            n = h
        mean, log_std, value = policy(leaves, obs, r, self.matmul)
        lp = log_prob(mean, log_std, action)
        ratio = torch.exp(lp - old_lp)
        adv = (advantage - adv_mean) / (adv_std + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - r.clip_eps, 1 + r.clip_eps) * adv
        pg_loss = -E.div(torch.sum(torch.minimum(pg1, pg2)), n)
        if r.value_clip > 0:
            v_clipped = old_value + torch.clamp(value - old_value,
                                                -r.value_clip, r.value_clip)
            v_loss = 0.5 * E.div(torch.sum(torch.maximum(
                (value - target) ** 2, (v_clipped - target) ** 2)), n)
        else:
            v_loss = 0.5 * E.div(torch.sum((value - target) ** 2), n)
        entropy = torch.sum(log_std + 0.5 * math.log(2 * math.pi * math.e))
        loss = pg_loss + r.value_coef * v_loss - r.entropy_coef * entropy
        approx_kl = E.div(torch.sum((ratio - 1.0) - (lp - old_lp)), n)
        return loss, torch.stack([pg_loss, v_loss, entropy, approx_kl])

    def update(self, leaves, opt: Adam, key, flat):
        r = self.r
        n = flat[0].shape[-1]
        block = r.shuffle_block if n % r.shuffle_block == 0 else 1
        nblocks = n // block
        mb = n // r.minibatches
        stop = torch.zeros((), dtype=torch.bool, device=key.device)
        aux = []
        for _ in range(r.epochs):
            key, sub = prng.split(key)
            perm = prng.permutation(sub, nblocks)
            shuffled = [x.reshape(*x.shape[:-1], nblocks, block)
                        .index_select(-2, perm).reshape(x.shape)
                        for x in flat]
            for i in range(r.minibatches):
                batch = [x[..., i * mb:(i + 1) * mb] for x in shuffled]
                with torch.enable_grad():
                    req = [p.detach().requires_grad_() for p in leaves]
                    loss, mb_aux = self.loss(req, *batch)
                    grads = list(torch.autograd.grad(loss, req))
                mb_aux = mb_aux.detach()
                updates, new_opt = adam_update(grads, opt, r, self.schedule)
                if r.target_kl > 0:
                    stop = stop | (mb_aux[3] > r.target_kl)
                    updates = [torch.where(stop, torch.zeros_like(u), u)
                               for u in updates]
                    new_opt = _adam_where(stop, opt, new_opt)
                opt = new_opt
                leaves = [(p + u).to(p.dtype) for p, u in zip(leaves, updates)]
                aux.append(mb_aux)
        return leaves, opt, key, torch.stack(aux).mean(0)

    def __call__(self, s: State):
        leaves = [p.detach() for p in s.leaves]
        env_state, obs, key, traj = self.rollout(leaves, s.env_state, s.obs,
                                                 s.key)
        flat, stats = self.advantages(leaves, traj, obs)
        leaves, opt, key, aux = self.update(leaves, s.opt, key, flat)
        self.updates += 1
        return (State(leaves=leaves, opt=opt, env_state=env_state, obs=obs,
                      key=key),
                torch.cat([stats, aux.to(stats.dtype)]))


METRICS = ('reward_per_step', 'episode_return_proxy', 'done_rate',
           'pg_loss', 'v_loss', 'entropy', 'approx_kl')


def total_loss(metrics, r: Recipe) -> float:
    """pg_loss + value_coef * v_loss - entropy_coef * entropy of a step's
    metrics (a dict by METRICS name or a sequence in METRICS order)."""
    m = metrics if isinstance(metrics, dict) else dict(zip(METRICS, metrics))
    return (float(m['pg_loss']) + r.value_coef * float(m['v_loss'])
            - r.entropy_coef * float(m['entropy']))


def initial_state(task: E.Task, r: Recipe, seed: int, num_envs: int,
                  device, weights_device=None):
    """The inputs that the benchmark hands to the program and to the
    reference alike, made from `seed`: the networks' initial weights
    (orthogonal at gain sqrt 2, the actor's last layer at 0.01, zero
    biases, log_std at init_log_std: normals from a torch.Generator on
    `device`, one QR each), the envs reset under a threefry key at episode
    0, the step key and the envs' reset key.  Returns (leaves, env_state,
    obs, key, base_key, env_ids)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % (1 << 63))
    h, o, a = r.hidden, len(task.obs_indices), task.action_size

    def orthogonal(n_out, n_in, scale):
        z = torch.randn((max(n_out, n_in), min(n_out, n_in)), generator=gen,
                        device=device, dtype=torch.float32)
        q, rr = torch.linalg.qr(z)
        q = q * torch.sign(torch.diagonal(rr))[None, :]
        if n_out < n_in:
            q = q.mT
        return (scale * q).contiguous()

    leaves = []
    for net, out in (('actor', a), ('critic', 1)):
        sizes = (o, h, h, out)
        for i, (n_in, n_out) in enumerate(zip(sizes[:-1], sizes[1:])):
            scale = math.sqrt(2.0)
            w = orthogonal(n_out, n_in, scale)
            if net == 'actor' and i == len(sizes) - 2:
                w = w * 0.01
            leaves += [w, torch.zeros((n_out,), dtype=torch.float32,
                                      device=device)]
    leaves.append(torch.full((a,), r.init_log_std, dtype=torch.float32,
                             device=device))
    key, base_key = prng.split(prng.PRNGKey(seed, device))
    env_ids = torch.arange(num_envs, dtype=torch.int32, device=device)
    env_state, obs = E.reset(base_key, env_ids,
                             torch.zeros(num_envs, dtype=torch.int32,
                                         device=device), task)
    return leaves, env_state, obs, key, base_key, env_ids
