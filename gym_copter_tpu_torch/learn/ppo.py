"""PPO actor-learner over batched copter environments, on torch.

The counterpart of `gym_copter_tpu/learn/ppo.py`: the same configuration,
networks, rollout, GAE, clipped loss, `target_kl` guard, block shuffle,
evaluation and training loop, and the same random draws (core/prng.py),
initial parameters included, so that a run from the same seed agrees with
the JAX package's to rounding.  Layout is features-first throughout: obs
(obs_dim, N), hidden (h, N), actions (A, N), the env batch on the last
axis.

Where the JAX package jits the whole train step into one XLA program, on the
card this one captures its three fixed-shape phases as CUDA graphs (the
T-step rollout, GAE with the flattening, and the epochs x minibatches
update), so that the host enqueues three graph launches per step instead of
some 10^5 small kernels.  The graphs run the same operations as the eager
path, which the CPU runs and which the graphed path is held against on the
card.  A capture that fails raises; nothing falls back to the eager path.

Sharded (`group=`, parallel/sharding.py), W ranks compute what one device
computes on the global batch, as the JAX step does under a mesh: each rank
rolls out its columns of the env batch (noise drawn over the global shape),
the rollout's metrics are all-reduced, the flattened rollout is all-gathered
in global order, and every minibatch of the global shuffle is split in W
column shares whose gradient sums are all-reduced before the same clip,
`target_kl` guard and Adam step on every rank.  Without a group the same
code runs with its collectives left out: the unsharded step is the W = 1
case.  NCCL collectives are captured in the graphs; gloo ones cannot be, so
a gloo world steps eagerly.

Action parameterization: env_action = hover * (1 + a), a ~ N(mu, sigma),
so a = 0 is hover (see the JAX module's docstring).
"""

from __future__ import annotations

import math
import sys
from typing import Callable, List, NamedTuple, Optional

import torch
import torch.distributed as dist
from torch import nn

from gym_copter_tpu_torch.control.heuristics import hover_motor_value
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.device import div, resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base
from gym_copter_tpu_torch.envs.base import EnvState, TaskSpec
from gym_copter_tpu_torch.learn import optim
from gym_copter_tpu_torch.parallel import sharding
from gym_copter_tpu_torch.utils import profiling


class PPOConfig(NamedTuple):
    """The JAX package's PPOConfig, field for field (its comments give each
    default's evidence)."""

    rollout_steps: int = 128
    learning_rate: float = 3e-4
    gamma: float = 0.99
    gae_lambda: float = 0.95
    clip_eps: float = 0.2
    epochs: int = 4
    # None = auto: scaled_minibatches(num_envs) where the batch is known
    minibatches: Optional[int] = None
    value_coef: float = 0.5
    entropy_coef: float = 1e-3
    max_grad_norm: float = 0.5
    hidden: int = 64
    init_log_std: float = -1.0
    obs_scale: float = 10.0
    # added to the actor-mean output: -1.0 starts with the motors off
    init_action_bias: float = -1.0
    value_clip: float = 0.2
    log_std_min: float = -4.0
    log_std_max: float = 0.5
    anneal_lr: bool = True
    anneal_lr_floor: float = 0.05
    # minibatch shuffle granularity in transitions; None = auto (128 at
    # num_envs >= 4096, else 1); falls back to 1 when T*B % block != 0
    shuffle_block: Optional[int] = None
    # skip the first minibatch whose approx-KL exceeds this, and all after
    # it in the update; 0 disables
    target_kl: float = 0.0
    # None = float32 dots; 'bfloat16' = bf16 operands, float32 products
    # (see mlp_apply)
    matmul_dtype: Optional[str] = None


def scaled_minibatches(num_envs: int, base_envs: int = 1024,
                       base_minibatches: int = 4) -> int:
    """Hold the minibatch SIZE of the tuned 1024-env x 128-step / 4
    minibatch recipe (32,768 transitions) fixed as the env batch grows."""
    return max(1, (num_envs * base_minibatches) // base_envs)


def resolve_minibatches(cfg: PPOConfig, num_envs: int) -> PPOConfig:
    """Resolve minibatches=None through scaled_minibatches (4 below 1024
    envs) and shuffle_block=None through the block-fraction rule, with the
    JAX package's warnings on stderr.  Idempotent."""
    if cfg.shuffle_block is None:
        cfg = cfg._replace(
            shuffle_block=128 if num_envs >= 4096 else 1)
    mbs = cfg.minibatches
    if mbs is None:
        mbs = scaled_minibatches(num_envs) if num_envs >= 1024 else 4
        if num_envs >= 1024 and num_envs % 256 != 0:
            print(f'WARNING: scaled_minibatches holds the tuned 32k '
                  f'minibatch size exactly only for num_envs % 256 == 0; '
                  f'num_envs={num_envs} gives minibatch size '
                  f'{num_envs * cfg.rollout_steps // mbs}', file=sys.stderr)
    else:
        mb_size = num_envs * cfg.rollout_steps // mbs
        if mb_size >= int(1.5 * 32768):
            print(f'WARNING: minibatch size {mb_size} >> the tuned 32768; '
                  f'large minibatches quartered learning at 4096 envs '
                  f'(docs/lander3d_curve_4096.json) — consider '
                  f'cfg.minibatches=None (auto) or '
                  f'ppo.scaled_minibatches({num_envs}) '
                  f'= {scaled_minibatches(num_envs)}', file=sys.stderr)
    n = num_envs * cfg.rollout_steps
    if n % mbs != 0:
        print(f'WARNING: {n} rollout transitions do not divide into '
              f'{mbs} minibatches; the trailing {n % mbs} transitions '
              f'of each epoch are dropped', file=sys.stderr)
    return cfg._replace(minibatches=mbs)


class Dense(nn.Module):
    """One layer: weight (out, in) for features-first inputs, bias (out,)."""

    def __init__(self, w: torch.Tensor, b: torch.Tensor):
        super().__init__()
        self.w = nn.Parameter(w, requires_grad=False)
        self.b = nn.Parameter(b, requires_grad=False)


class ActorCritic(nn.Module):
    """The JAX package's params pytree as a module: actor and critic MLPs
    obs -> hidden -> hidden -> out with tanh between layers, and the
    learnable exploration log-std (A,).

    The learner works on `leaves()`, the tensors in a fixed order (actor
    w, b per layer, then critic, then log_std), and builds the next params
    with `from_leaves`; the parameters carry no autograd state."""

    def __init__(self, actor, critic, log_std: torch.Tensor):
        """actor, critic: sequences of (w, b) pairs."""
        super().__init__()
        self.actor = nn.ModuleList([Dense(w, b) for w, b in actor])
        self.critic = nn.ModuleList([Dense(w, b) for w, b in critic])
        self.log_std = nn.Parameter(log_std, requires_grad=False)

    def leaves(self) -> List[torch.Tensor]:
        ps = [p for layer in (*self.actor, *self.critic)
              for p in (layer.w, layer.b)] + [self.log_std]
        return [p.detach() for p in ps]

    @classmethod
    def from_leaves(cls, leaves: List[torch.Tensor]) -> 'ActorCritic':
        actor, critic, log_std = unflatten(leaves)
        return cls(actor, critic, log_std)

    def forward(self, obs: torch.Tensor, cfg: PPOConfig):
        """(mean (A, N), log_std (A, 1), value (N,))."""
        return _policy(self.leaves(), obs, cfg)


def unflatten(leaves):
    """Leaves in `ActorCritic.leaves()` order -> (actor (w, b) pairs,
    critic (w, b) pairs, log_std)."""
    n = (len(leaves) - 1) // 2

    def pairs(ts):
        return list(zip(ts[0::2], ts[1::2]))

    return pairs(leaves[:n]), pairs(leaves[n:2 * n]), leaves[-1]


def _orthogonal(key: torch.Tensor, n_out: int, n_in: int, scale: float,
                dtype) -> torch.Tensor:
    """`jax.nn.initializers.orthogonal(scale)(key, (n_out, n_in), dtype)`,
    which is `jax.random.orthogonal`: a threefry normal of shape (max,
    min) of the two sizes, its QR, Q's columns times the signs of R's
    diagonal, transposed when n_out < n_in, then times the scale rounded
    to `dtype`.  On the CPU; the QR is torch's LAPACK call, not XLA's, so
    the result equals JAX's to rounding (tests/test_torch_init_bf16.py)."""
    z = prng.normal(key.cpu(), (max(n_out, n_in), min(n_out, n_in)), dtype)
    q, r = torch.linalg.qr(z)
    q = q * torch.sign(torch.diagonal(r))[None, :]
    if n_out < n_in:
        q = q.mT
    # LAPACK's Q is column-major; collectives need row-major tensors
    return (torch.tensor(scale, dtype=dtype) * q).contiguous()


def init_mlp_params(key: torch.Tensor, sizes, dtype=torch.float32):
    """The JAX package's `init_mlp_params`: one key per layer from
    split(key), orthogonal weights (out, in) at gain sqrt 2, zero biases.
    Returns (w, b) pairs on the CPU."""
    keys = prng.split(key.cpu(), len(sizes) - 1)
    return [(_orthogonal(k, n_out, n_in, math.sqrt(2.0), dtype),
             torch.zeros((n_out,), dtype=dtype))
            for k, (n_in, n_out) in zip(keys, zip(sizes[:-1], sizes[1:]))]


def init_params(key: torch.Tensor, obs_size: int, action_size: int,
                cfg: PPOConfig, dtype=torch.float32) -> ActorCritic:
    """The JAX package's `init_params` for the same key: the actor from
    split(key)[0] with its last layer scaled by 0.01, the critic from
    split(key)[1], log_std at cfg.init_log_std; on the key's device."""
    k1, k2 = prng.split(key.cpu())
    h = cfg.hidden
    actor = init_mlp_params(k1, (obs_size, h, h, action_size), dtype)
    actor[-1] = (actor[-1][0] * 0.01, actor[-1][1])
    critic = init_mlp_params(k2, (obs_size, h, h, 1), dtype)
    log_std = torch.full((action_size,), cfg.init_log_std, dtype=dtype)
    return ActorCritic(actor, critic, log_std).to(key.device)


def _check_exact_fp32_products():
    """Raise where the card may compute float32 products in TF32, which
    would round every operand to 10 bits instead of computing the products
    asked for."""
    if torch.backends.cuda.matmul.allow_tf32 or \
            torch.get_float32_matmul_precision() != 'highest' or \
            getattr(torch.backends.cuda.matmul, 'fp32_precision',
                    'none') not in ('none', 'ieee'):
        raise RuntimeError(
            'float32 matmuls on the card are set to drop to TF32 '
            '(torch.backends.cuda.matmul.allow_tf32 or '
            'torch.set_float32_matmul_precision); the PPO networks need '
            'exact float32 products: restore the default "highest"')


def mlp_apply(layers, x: torch.Tensor, matmul_dtype=None) -> torch.Tensor:
    """x: (in, N) -> (out, N); tanh hidden activations.  layers: (w, b)
    pairs.

    matmul_dtype='bfloat16' rounds weights and activations to bf16 for the
    products and multiplies them in float32: the product of two bf16
    values is exact in float32, so this is JAX's bf16 `dot_general` with
    `preferred_element_type=float32`, to float32 summation order.  Biases
    and everything between the products stay float32."""
    if x.is_cuda:
        _check_exact_fp32_products()
    for i, (w, b) in enumerate(layers):
        if matmul_dtype is not None:
            dt = getattr(torch, matmul_dtype)
            x = (w.to(dt).float() @ x.to(dt).float()) + b[:, None]
        else:
            dt = torch.promote_types(w.dtype, x.dtype)
            x = w.to(dt) @ x.to(dt) + b[:, None]
        if i < len(layers) - 1:
            x = torch.tanh(x)
    return x


def _clipped_log_std(log_std: torch.Tensor, cfg: PPOConfig):
    return torch.clamp(log_std, cfg.log_std_min, cfg.log_std_max)


def _policy(leaves, obs: torch.Tensor, cfg: PPOConfig):
    """Returns (mean (A,N), log_std (A,1), value (N,))."""
    actor, critic, log_std = unflatten(leaves)
    x = div(obs, cfg.obs_scale)
    mean = mlp_apply(actor, x, cfg.matmul_dtype) + cfg.init_action_bias
    value = mlp_apply(critic, x, cfg.matmul_dtype)[0]
    return mean, _clipped_log_std(log_std, cfg)[:, None], value


def _log_prob(mean, log_std, action):
    """Diagonal-Gaussian log density summed over the action axis (axis 0)."""
    z = (action - mean) * torch.exp(-log_std)
    return torch.sum(-0.5 * z * z - log_std - 0.5 * math.log(2 * math.pi),
                     dim=0)


class Transition(NamedTuple):
    obs: torch.Tensor       # (obs_dim, B)
    action: torch.Tensor    # (A, B) raw normalized action
    log_prob: torch.Tensor  # (B,)
    value: torch.Tensor     # (B,)
    reward: torch.Tensor    # (B,)
    done: torch.Tensor      # (B,)


class TrainState(NamedTuple):
    params: ActorCritic
    opt_state: optim.AdamState
    env_state: EnvState
    obs: torch.Tensor        # (obs_dim, B)
    key: torch.Tensor        # (2,) int64 threefry key
    update_idx: torch.Tensor  # () int32


METRICS = ('reward_per_step', 'episode_return_proxy', 'done_rate',
           'pg_loss', 'v_loss', 'entropy', 'approx_kl')


class TrainStep:
    """One PPO update (rollout, GAE, epochs x minibatches of clipped-loss
    Adam steps) as `make_train_step` returns it: `step(ts) -> (ts,
    metrics)`, graphed on the card, eager on the CPU; `step.eager(ts)`
    is the eager path anywhere.  Neither modifies `ts`.

    The rollout is graphed as one policy + env step replayed T times,
    which measured faster on the H100 than the whole T-step rollout as one
    graph (PERF.md).

    With a process `group`, `env_ids` are the global ids of this rank's
    columns of the env batch (rank r of W holds [r·b, (r+1)·b)), the
    TrainState holds those columns, and every rank ends each step with the
    same parameters and optimizer state."""

    def __init__(self, env_params: EnvParams, spec: TaskSpec,
                 cfg: PPOConfig, base_key, env_ids, optimizer, group=None):
        self.env_params, self.spec, self.cfg = env_params, spec, cfg
        self.base_key, self.env_ids = base_key, env_ids
        self.optimizer = optimizer
        self.hover = hover_motor_value(env_params)
        self.group = group
        self.rank, self.world = sharding.world_of(group)
        self.num_envs = int(env_ids.shape[0]) * self.world
        self.cols = sharding.env_columns(self.num_envs, self.rank,
                                         self.world)
        mb = self.num_envs * cfg.rollout_steps // cfg.minibatches
        if mb % self.world != 0:
            raise ValueError(f'minibatch of {mb} transitions does not split '
                             f'into {self.world} equal shares')
        # the lambdas read the phase methods at capture time
        self.rollout_graph = Graph(lambda *a: self.rollout(*a, 1), warmup=1,
                                   name='ppo.rollout_step')
        self.gae_graph = Graph(lambda *a: self.advantages(*a), warmup=1,
                               name='ppo.gae')
        self.update_graph = Graph(lambda *a: self.update(*a), warmup=3,
                                  name='ppo.update')

    # -- the three phases, as pure functions of tensors -------------------

    def rollout(self, leaves, env_state, obs, key, num_steps: int):
        """num_steps policy + env steps -> (env_state, obs, key, Transition
        with a leading time axis).  A capture counts the nodes of the
        `ppo.policy` region and of the env step's (envs/base.py)."""
        cfg, traj = self.cfg, []
        with torch.no_grad():
            for _ in range(num_steps):
                profiling.region('ppo.policy')
                key, sub = prng.split(key)
                mean, log_std, value = _policy(leaves, obs, cfg)
                # this rank's columns of the global draw
                noise = prng.normal(sub, (mean.shape[0], self.num_envs),
                                    mean.dtype, cols=self.cols)
                action = mean + torch.exp(log_std) * noise
                log_prob = _log_prob(mean, log_std, action)
                env_action = self.hover * (1.0 + action)
                env_state, ts = base.step(env_state, env_action,
                                          self.base_key, self.env_ids,
                                          self.env_params, self.spec)
                traj.append(Transition(obs=obs, action=action,
                                       log_prob=log_prob, value=value,
                                       reward=ts.reward, done=ts.done))
                obs = ts.obs
        return env_state, obs, key, Transition(
            *(torch.stack(field) for field in zip(*traj)))

    def advantages(self, leaves, traj: Transition, obs):
        """GAE over the trajectory (a reverse loop over T), flattened to
        (…, T*B) features-first over the global batch; and the rollout's
        three metrics over the global batch."""
        cfg = self.cfg
        with torch.no_grad():
            _, _, last_value = _policy(leaves, obs, cfg)
            next_values = torch.cat([traj.value[1:], last_value[None]], dim=0)
            nonterminal = 1.0 - traj.done.to(torch.float32)
            delta = traj.reward + cfg.gamma * next_values * nonterminal \
                - traj.value
            decay = cfg.gamma * cfg.gae_lambda * nonterminal
            adv = torch.empty_like(delta)
            gae = torch.zeros_like(last_value)
            for t in reversed(range(delta.shape[0])):
                gae = delta[t] + decay[t] * gae
                adv[t] = gae
            target = adv + traj.value
            sums = torch.stack([traj.reward.sum(), traj.reward.sum(0).sum(),
                                traj.done.to(traj.reward.dtype).sum()])
            parts = (traj.obs, traj.action, traj.log_prob, traj.value, adv,
                     target)
            if self.group is not None:
                dist.all_reduce(sums, group=self.group)
                # one all-gather of the six (T, …, b) parts packed as rows
                rows = torch.cat([traj.obs, traj.action, torch.stack(
                    [traj.log_prob, traj.value, adv, target], 1)], 1)
                rows = sharding.gather_columns(rows, self.group)
                d, a = traj.obs.shape[1], traj.action.shape[1]
                parts = (rows[:, :d], rows[:, d:d + a]) + tuple(
                    rows[:, d + a + i] for i in range(4))

            def flat3(x):  # (T, D, B) -> (D, T*B)
                return torch.movedim(x, 1, 0).reshape(x.shape[1], -1)

            flat = (flat3(parts[0]), flat3(parts[1])) + tuple(
                x.reshape(-1) for x in parts[2:])
            steps = traj.reward.shape[0] * self.num_envs
            stats = torch.stack([div(sums[0], steps),
                                 div(sums[1], self.num_envs),
                                 div(sums[2], steps)])
        return flat, stats

    def loss(self, leaves, obs, action, old_log_prob, old_value, advantage,
             target, share=None):
        """The clipped surrogate with value loss and entropy bonus over the
        minibatch given; returns (loss, (pg_loss, v_loss, entropy,
        approx_kl) stacked).

        With share = (lo, hi), this rank's columns of it: their sums over
        the whole minibatch's size, the advantages normalized by the whole
        minibatch's mean and std, and the data-free entropy term on rank 0
        only, so that the ranks' losses, gradients and aux sum to the whole
        minibatch's."""
        cfg = self.cfg
        n = advantage.shape[-1]
        adv_mean, adv_std = advantage.mean(), advantage.std(correction=0)
        if share is not None:
            obs, action, old_log_prob, old_value, advantage, target = (
                x[..., share[0]:share[1]] for x in (
                    obs, action, old_log_prob, old_value, advantage, target))
        mean, log_std, value = _policy(leaves, obs, cfg)
        log_prob = _log_prob(mean, log_std, action)
        ratio = torch.exp(log_prob - old_log_prob)
        adv = (advantage - adv_mean) / (adv_std + 1e-8)
        pg1 = ratio * adv
        pg2 = torch.clamp(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * adv
        pg_loss = -div(torch.sum(torch.minimum(pg1, pg2)), n)
        if cfg.value_clip > 0:
            v_clipped = old_value + torch.clamp(value - old_value,
                                                -cfg.value_clip,
                                                cfg.value_clip)
            v_loss = 0.5 * div(torch.sum(torch.maximum(
                (value - target) ** 2, (v_clipped - target) ** 2)), n)
        else:
            v_loss = 0.5 * div(torch.sum((value - target) ** 2), n)
        if self.rank == 0:
            entropy = torch.sum(log_std
                                + 0.5 * math.log(2 * math.pi * math.e))
        else:
            entropy = log_std.new_zeros(())
        loss = pg_loss + cfg.value_coef * v_loss - cfg.entropy_coef * entropy
        # the low-variance k3 estimator E[ratio - 1 - log ratio]
        approx_kl = div(torch.sum((ratio - 1.0) - (log_prob - old_log_prob)),
                        n)
        return loss, torch.stack([pg_loss, v_loss, entropy, approx_kl])

    def _all_reduce(self, grads, aux):
        """The sums over the ranks of every gradient and of aux, in one
        all-reduce of the flattened tensors."""
        flat = torch.cat([g.reshape(-1) for g in grads] + [aux])
        dist.all_reduce(flat, group=self.group)
        parts = torch.split(flat, [g.numel() for g in grads] + [aux.numel()])
        return ([p.view_as(g) for p, g in zip(parts, grads)],
                parts[-1].view_as(aux))

    def update(self, leaves, opt_state: optim.AdamState, key, flat):
        """cfg.epochs passes over the flattened rollout, each a block
        shuffle and cfg.minibatches contiguous minibatch steps, with the
        per-minibatch target_kl guard: from the first minibatch whose
        approx-KL (on the params before its own step) exceeds the target,
        updates are zeroed and the optimizer state kept.  Returns (leaves,
        opt_state, key, mean of (pg_loss, v_loss, entropy, approx_kl)).

        Every rank holds the whole flattened rollout and draws the same
        shuffle; it takes the gradient of its column share of each
        minibatch, and the shares' sums, all-reduced with the aux before
        the guard reads approx_kl, give every rank the same step.  A
        capture counts the nodes of each minibatch's `ppo.loss_grad` and
        `ppo.optimizer` regions."""
        cfg = self.cfg
        n = flat[0].shape[-1]
        block = cfg.shuffle_block if n % cfg.shuffle_block == 0 else 1
        nblocks = n // block
        mb = n // cfg.minibatches
        share = (self.rank * mb // self.world,
                 (self.rank + 1) * mb // self.world)
        stop = torch.zeros((), dtype=torch.bool, device=key.device)
        aux = []
        for _ in range(cfg.epochs):
            key, sub = prng.split(key)
            perm = prng.permutation(sub, nblocks)
            shuffled = [x.reshape(*x.shape[:-1], nblocks, block)
                        .index_select(-2, perm).reshape(x.shape)
                        for x in flat]
            for i in range(cfg.minibatches):
                batch = [x[..., i * mb:(i + 1) * mb] for x in shuffled]
                profiling.region('ppo.loss_grad')
                with torch.enable_grad():
                    req = [p.detach().requires_grad_() for p in leaves]
                    loss, mb_aux = self.loss(req, *batch, share=share)
                    grads = list(torch.autograd.grad(loss, req))
                mb_aux = mb_aux.detach()
                if self.group is not None:
                    grads, mb_aux = self._all_reduce(grads, mb_aux)
                profiling.region('ppo.optimizer')
                if cfg.target_kl > 0:
                    stop = stop | (mb_aux[3] > cfg.target_kl)
                leaves, opt_state = self.optimizer.step(
                    leaves, grads, opt_state,
                    stop if cfg.target_kl > 0 else None)
                profiling.region(None)
                aux.append(mb_aux)
        return leaves, opt_state, key, torch.stack(aux).mean(0)

    # -- the step ---------------------------------------------------------

    def __call__(self, ts: TrainState):
        return self.run(ts, graphed=ts.obs.is_cuda)

    def eager(self, ts: TrainState):
        return self.run(ts, graphed=False)

    def _graphed_rollout(self, leaves, env_state, obs, key):
        """The one-step rollout graph replayed T times into one
        trajectory: the span `ppo.rollout.host_loop` while the recorder is
        on."""
        g, t_len = self.rollout_graph, self.cfg.rollout_steps
        traj = None
        with profiling.span('ppo.rollout.host_loop'):
            for t in range(t_len):
                env_state, obs, key, one = g(leaves, env_state, obs, key)
                leaves = g.inputs[0]
                if traj is None:
                    traj = Transition(*(x.new_empty((t_len,) + x.shape[1:])
                                        for x in one))
                for buf, x in zip(traj, one):
                    buf[t].copy_(x[0])
        return env_state, obs, key, traj

    def run(self, ts: TrainState, graphed: bool, marks=None):
        """One train step; `marks`, a list, receives a recorded CUDA event
        before the rollout and after each phase (for timing on the card).
        While the recorder of utils/profiling.py is on, the step is the
        span `ppo.step` and its phases `ppo.rollout`, `ppo.gae` and
        `ppo.update`, timed on the card by the same events."""
        if graphed and self.group is not None and \
                dist.get_backend(self.group) != 'nccl':
            raise ValueError('a CUDA graph cannot capture gloo collectives: '
                             'step a gloo world eagerly (step.eager)')
        if graphed and not ts.obs.is_cuda:
            raise ValueError('CUDA graphs need the train state on the card')
        with profiling.Phases('ppo.step', marks,
                              events=ts.obs.is_cuda) as phases:
            leaves = ts.params.leaves()
            phases.next('ppo.rollout')
            if graphed:
                env_state, obs, key, traj = self._graphed_rollout(
                    leaves, ts.env_state, ts.obs, ts.key)
            else:
                env_state, obs, key, traj = self.rollout(
                    leaves, ts.env_state, ts.obs, ts.key,
                    self.cfg.rollout_steps)
            phases.next('ppo.gae')
            adv_fn = self.gae_graph if graphed else self.advantages
            flat, stats = adv_fn(leaves, traj, obs)
            phases.next('ppo.update')
            upd_fn = self.update_graph if graphed else self.update
            leaves, opt_state, key, aux = upd_fn(leaves, ts.opt_state, key,
                                                 flat)
            phases.next()
            metrics = torch.cat([stats, aux.to(stats.dtype)])
            if graphed:
                # the graphs' static outputs are overwritten by the next
                # replay
                leaves, opt_state, env_state, obs, key = tree_map(
                    torch.clone, (leaves, opt_state, env_state, obs, key))
            new_ts = TrainState(params=ActorCritic.from_leaves(leaves),
                                opt_state=opt_state, env_state=env_state,
                                obs=obs, key=key,
                                update_idx=ts.update_idx + 1)
        return new_ts, dict(zip(METRICS, metrics.unbind()))


def make_train_step(env_params: EnvParams, spec: TaskSpec, cfg: PPOConfig,
                    base_key, env_ids, optimizer=None, group=None):
    """The PPO train step over the envs `env_ids` (auto-resets keyed by
    `base_key`), on their device: `(train_step, optimizer)`.  optimizer
    defaults to clip_by_global_norm(cfg.max_grad_norm) then Adam at
    cfg.learning_rate.  With a process `group`, `env_ids` are this rank's
    global ids and the minibatches resolve for the global batch."""
    world = sharding.world_of(group)[1]
    cfg = resolve_minibatches(cfg, int(env_ids.shape[0]) * world)
    if optimizer is None:
        optimizer = optim.ClipAdam(cfg.max_grad_norm, cfg.learning_rate)
    return TrainStep(env_params, spec, cfg, base_key, env_ids,
                     optimizer, group), optimizer


def init_train_state(key, env_params: EnvParams, spec: TaskSpec,
                     cfg: PPOConfig, num_envs: int, optimizer,
                     env_id_offset: int = 0,
                     dtype=torch.float32) -> TrainState:
    """The JAX package's `init_train_state`: params from split(key)[0]
    (`init_params`), the envs reset under `key` at episode 0, and
    split(key)[1] as the step key, on key's device."""
    kp, kr = prng.split(key)
    device = key.device
    params = init_params(kp, spec.obs_size, spec.action_size, cfg, dtype)
    env_ids = env_id_offset + torch.arange(num_envs, dtype=torch.int32,
                                           device=device)
    env_state, obs = base.reset(
        key, env_ids, torch.zeros(num_envs, dtype=torch.int32, device=device),
        env_params, spec, dtype=dtype)
    return TrainState(params=params, opt_state=optimizer.init(params.leaves()),
                      env_state=env_state, obs=obs, key=kr,
                      update_idx=torch.zeros((), dtype=torch.int32,
                                             device=device))


# eval batch used by train()'s learning-curve metric; tests that re-evaluate
# a returned policy must use the same batch to reproduce the curve value
EVAL_NUM_ENVS = 1024


def make_eval_fn(env_params: EnvParams, spec: TaskSpec, cfg: PPOConfig,
                 num_envs: int = EVAL_NUM_ENVS, num_steps: int = 999,
                 seed: int = 1000, device=None) -> Callable:
    """Deterministic-policy evaluation: fresh episodes (key PRNGKey(seed),
    episode 0), mean actions, each env's return summed up to its first
    done, averaged over the batch — the learning-curve metric.

    Returns `evaluate(params, graphed=None) -> (mean return, per-env
    returns)`.  Graphed (the default for params on the card), it replays a
    one-step CUDA graph num_steps times, as the train step's rollout does;
    `graphed=False` runs the same steps eagerly."""
    hover = hover_motor_value(env_params)
    device = resolve_device(device)
    base_key = prng.PRNGKey(seed, device)
    env_ids = torch.arange(num_envs, dtype=torch.int32, device=device)
    env_state, obs = base.reset(
        base_key, env_ids,
        torch.zeros(num_envs, dtype=torch.int32, device=device),
        env_params, spec)
    start = (env_state, obs,
             torch.zeros(num_envs, dtype=torch.float32, device=device),
             torch.zeros(num_envs, dtype=torch.bool, device=device))

    def steps(leaves, env_state, obs, total, done_seen, n=1):
        """n steps under the mean action; returns the carry."""
        with torch.no_grad():
            for _ in range(n):
                mean, _, _ = _policy(leaves, obs, cfg)
                env_state, ts = base.step(env_state, hover * (1.0 + mean),
                                          base_key, env_ids, env_params, spec)
                total = total + torch.where(done_seen, 0.0, ts.reward)
                done_seen = done_seen | ts.done
                obs = ts.obs
        return env_state, obs, total, done_seen

    graph = Graph(steps, warmup=1)

    def evaluate(params: ActorCritic, graphed: Optional[bool] = None):
        leaves = params.leaves()
        if graphed is None:
            graphed = leaves[0].is_cuda
        if not graphed:
            total = steps(leaves, *start, num_steps)[2]
            return total.mean(), total
        carry = start
        for _ in range(num_steps):
            carry = graph(leaves, *carry)
            leaves = graph.inputs[0]
        total = carry[2].clone()
        return total.mean(), total

    return evaluate


def train_optimizer(cfg: PPOConfig, num_updates: int) -> optim.ClipAdam:
    """The optimizer `train` steps with: Adam at cfg.learning_rate, annealed
    linearly over every optimizer step of `num_updates` updates where
    cfg.anneal_lr says so.  cfg's minibatches must be resolved."""
    lr = cfg.learning_rate
    if cfg.anneal_lr:
        lr = optim.linear_schedule(
            init_value=cfg.learning_rate,
            end_value=cfg.learning_rate * cfg.anneal_lr_floor,
            transition_steps=num_updates * cfg.epochs * cfg.minibatches)
    return optim.ClipAdam(cfg.max_grad_norm, lr)


def train(env_name: str = 'Hover3D-v0', num_envs: int = 1024,
          num_updates: int = 200, seed: int = 0,
          cfg: PPOConfig = PPOConfig(), env_params: EnvParams = None,
          log_every: int = 10, callback=None, keep_best: bool = False,
          device=None, group=None, dtype=torch.float32):
    """The training loop: make, init, num_updates train steps with the
    learning rate annealed linearly over every optimizer step, and a
    deterministic evaluation every `log_every` updates and at the last.
    Runs on the card unless device='cpu'; `dtype` is the parameters' and
    the env state's.  Returns (TrainState, history [(update, metrics)]);
    with keep_best the params are the best evaluated ones.

    With a process `group` (parallel/sharding.py `init_world`), `num_envs`
    is the global batch and each rank steps its columns on `device`; the
    parameters and optimizer state start from rank 0's.  Rank 0 evaluates
    and returns the history; the others return an empty one.  A gloo group
    on the card raises, since its collectives cannot be graphed."""
    from gym_copter_tpu_torch.envs.registry import resolve_params

    device = resolve_device(device)
    spec, env_params = resolve_params(env_name, env_params)
    cfg = resolve_minibatches(cfg, num_envs)
    rank, world = sharding.world_of(group)
    lo, hi = sharding.env_columns(num_envs, rank, world)

    key = prng.PRNGKey(seed, device)
    base_key = prng.PRNGKey(seed + 1, device)
    env_ids = torch.arange(lo, hi, dtype=torch.int32, device=device)
    step, optimizer = make_train_step(env_params, spec, cfg, base_key,
                                      env_ids,
                                      optimizer=train_optimizer(cfg,
                                                                num_updates),
                                      group=group)
    ts = init_train_state(key, env_params, spec, cfg, hi - lo, optimizer,
                          env_id_offset=lo, dtype=dtype)
    if group is not None:
        ts = ts._replace(params=sharding.replicate(ts.params, group),
                         opt_state=sharding.replicate(ts.opt_state, group))
    evaluate = (make_eval_fn(env_params, spec, cfg, num_envs=EVAL_NUM_ENVS,
                             device=device) if rank == 0 else None)
    history = []
    best_eval, best_params = -float('inf'), None
    for i in range(num_updates):
        ts, metrics = step(ts)
        if rank == 0 and (i % log_every == 0 or i == num_updates - 1):
            metrics = {k: float(v) for k, v in metrics.items()}
            metrics['eval_return'] = float(evaluate(ts.params)[0])
            if keep_best and metrics['eval_return'] > best_eval:
                best_eval = metrics['eval_return']
                best_params = ActorCritic.from_leaves(
                    [p.clone() for p in ts.params.leaves()])
            history.append((i, metrics))
            if callback:
                callback(i, metrics)
            else:
                print(f'update {i:4d}  eval_return '
                      f'{metrics["eval_return"]:8.2f}  reward/step '
                      f'{metrics["reward_per_step"]:7.4f}  done '
                      f'{metrics["done_rate"]:.3f}')
    if keep_best and best_params is not None:
        ts = ts._replace(params=best_params)
    return ts, history
