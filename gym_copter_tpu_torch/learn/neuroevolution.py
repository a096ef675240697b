"""NEAT-style neuroevolution on torch: the counterpart of
`gym_copter_tpu/learn/neuroevolution.py`, whose docstring gives the design
and its sources in the reference (attic/neat).

Every genome carries a fixed maximum topology (direct input -> output
connections plus one recurrent hidden block) with a {0, 1} mask per
connection, so the whole population x episode_reps batch steps in lockstep
as one env batch, the networks as population-stacked `torch.einsum`s.
Evolution is elitism, tournament selection, gene-level crossover, weight
perturb/replace/clip and mask mutation, with the JAX package's random draws
(core/prng.py) in its key order, so one `evolve` from the same inputs gives
the same parents, elites and masks.

Genomes carry their dtype (float32 by default, as the card runs; float64
where the tests match the JAX package under x64): the network, the hidden
state and every draw of `evolve` are in it, and tournament indices are
drawn 64 bits wide for float64 genomes, 32 otherwise, as JAX's default int
is.  The env stays float32.

On the card the fitness replays a one-step CUDA graph (env step and
network) max_steps times; the reset for the generation's episode runs
before it, outside the graph.  With a process `group`
(parallel/sharding.py), each rank evaluates its contiguous slice of the
genomes on its columns of the env batch, keyed by their global env ids, and
the (P,) fitness is all-gathered.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from gym_copter_tpu_torch.control.heuristics import hover_motor_value
from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.device import resolve_device
from gym_copter_tpu_torch.core.graph import Graph
from gym_copter_tpu_torch.core.tree import tree_map
from gym_copter_tpu_torch.core.types import EnvParams
from gym_copter_tpu_torch.envs import base
from gym_copter_tpu_torch.envs.registry import resolve_params
from gym_copter_tpu_torch.parallel import sharding


class Genome(NamedTuple):
    """Population-stacked genomes (leading axis = pop); (weight, mask)
    pairs, a mask bit being NEAT's per-gene `enabled` flag."""

    w_dir: torch.Tensor   # (P, A, O)
    m_dir: torch.Tensor
    w_in: torch.Tensor    # (P, H, O)
    m_in: torch.Tensor
    w_rec: torch.Tensor   # (P, H, H)
    m_rec: torch.Tensor
    w_out: torch.Tensor   # (P, A, H)
    m_out: torch.Tensor
    b_h: torch.Tensor     # (P, H)
    b_out: torch.Tensor   # (P, A)


_PAIRS = (('w_dir', 'm_dir'), ('w_in', 'm_in'),
          ('w_rec', 'm_rec'), ('w_out', 'm_out'))
_BIASES = ('b_h', 'b_out')


@dataclasses.dataclass(frozen=True)
class NeatConfig:
    """The JAX package's NeatConfig, field for field (its comments give
    each default's source)."""

    pop_size: int = 96
    episode_reps: int = 10
    fitness_threshold: float = 300.0
    hidden: int = 16
    n_elite: int = 2
    tournament: int = 3
    crossover_rate: float = 0.75
    weight_mutate_rate: float = 0.8
    weight_mutate_power: float = 0.5
    weight_replace_rate: float = 0.1
    weight_init_stdev: float = 1.0
    weight_clip: float = 8.0
    conn_enable_per_child: float = 2.0
    conn_disable_per_child: float = 0.2
    # 'hover': action = hover * (1 + tanh output); 'direct': the tanh output
    action_anchor: str = 'hover'
    max_steps: int = 999
    # champion selection: each generation's top-k by train fitness are
    # re-scored on a fixed holdout of holdout_reps episodes
    topk: int = 4
    holdout_reps: int = 32
    holdout_margin: float = 10.0


def index_bits(dtype) -> int:
    """The width of JAX's default int beside a float dtype: 64 bits under
    x64 (float64), 32 otherwise."""
    return 64 if dtype == torch.float64 else 32


def network_step(genome: Genome, obs_pr, h_pr):
    """One tick of every genome's recurrent net.  obs_pr (O, P, R) and h_pr
    (H, P, R) in the genome's dtype; returns (new hidden, tanh outputs
    (A, P, R)).  A masked connection contributes exactly nothing."""
    h_pr = torch.tanh(
        torch.einsum('pho,opr->hpr', genome.w_in * genome.m_in, obs_pr)
        + torch.einsum('phg,gpr->hpr', genome.w_rec * genome.m_rec, h_pr)
        + genome.b_h.T[:, :, None])
    out = torch.tanh(
        torch.einsum('pah,hpr->apr', genome.w_out * genome.m_out, h_pr)
        + torch.einsum('pao,opr->apr', genome.w_dir * genome.m_dir, obs_pr)
        + genome.b_out.T[:, :, None])
    return h_pr, out


def init_population(key, obs_size: int, action_size: int, cfg: NeatConfig,
                    dtype=torch.float32) -> Genome:
    """`initial_connection = full_direct`: every direct connection enabled,
    the hidden block present but masked off; on key's device."""
    P, H, O, A = cfg.pop_size, cfg.hidden, obs_size, action_size
    ks = prng.split(key, 6)
    std = cfg.weight_init_stdev

    def normal(k, shape):
        return std * prng.normal(k, shape, dtype)

    def mask(shape, value):
        return torch.full(shape, value, dtype=dtype, device=key.device)

    return Genome(
        w_dir=normal(ks[0], (P, A, O)), m_dir=mask((P, A, O), 1.0),
        w_in=normal(ks[1], (P, H, O)), m_in=mask((P, H, O), 0.0),
        w_rec=normal(ks[2], (P, H, H)), m_rec=mask((P, H, H), 0.0),
        w_out=normal(ks[3], (P, A, H)), m_out=mask((P, A, H), 0.0),
        b_h=normal(ks[4], (P, H)), b_out=normal(ks[5], (P, A)))


class Fitness:
    """`fitness(genome, episode, graphed=None)` -> (P,) mean first-episode
    return over `reps` fresh envs per genome (or the (P, R) returns with
    `return_episodes`), as `make_fitness_fn` makes it.  Graphed (the default
    for a genome on the card), one network + env step is a CUDA graph
    replayed max_steps times; `graphed=False` runs the same steps eagerly.
    """

    def __init__(self, env_name: str, cfg: NeatConfig,
                 env_params: Optional[EnvParams], reps: Optional[int],
                 seed: int, group, return_episodes: bool, device):
        self.spec, self.env_params = resolve_params(env_name, env_params)
        self.cfg, self.group = cfg, group
        self.return_episodes = return_episodes
        P = cfg.pop_size
        self.R = reps if reps is not None else cfg.episode_reps
        rank, world = sharding.world_of(group)
        if P % world:
            raise ValueError(f'pop_size {P} not divisible by {world} ranks')
        lo, hi = sharding.env_columns(P * self.R, rank, world)
        self.genomes = (lo // self.R, hi // self.R)
        self.p = hi // self.R - lo // self.R
        self.device = resolve_device(device)
        self.base_key = prng.PRNGKey(seed, self.device)
        self.env_ids = torch.arange(lo, hi, dtype=torch.int32,
                                    device=self.device)
        self.hover = (hover_motor_value(self.env_params)
                      if cfg.action_anchor == 'hover' else None)
        self.graph = Graph(self.steps, warmup=1)

    def start(self, genome: Genome, episode):
        """This rank's genomes and the carry (env state, obs, hidden state,
        totals, done flags) of fresh episodes `episode`."""
        lo, hi = self.genomes
        if (lo, hi) != (0, genome.w_dir.shape[0]):
            genome = tree_map(lambda g: g[lo:hi], genome)
        b = self.env_ids.shape[0]
        ep = torch.full((b,), int(episode), dtype=torch.int32,
                        device=self.device)
        env_state, obs = base.reset(self.base_key, self.env_ids, ep,
                                    self.env_params, self.spec)
        dtype = genome.w_dir.dtype
        h = torch.zeros((self.cfg.hidden, self.p, self.R), dtype=dtype,
                        device=self.device)
        return genome, (env_state, obs, h,
                        torch.zeros(b, dtype=torch.float32,
                                    device=self.device),
                        torch.zeros(b, dtype=torch.bool, device=self.device))

    def steps(self, genome: Genome, env_state, obs, h, total, done_seen,
              n: int = 1):
        """n network + env steps; returns the carry."""
        O, A = self.spec.obs_size, self.spec.action_size
        shape = (self.p, self.R)
        for _ in range(n):
            h, out = network_step(genome,
                                  obs.reshape(O, *shape).to(h.dtype), h)
            act = self.hover * (1.0 + out) if self.hover is not None else out
            env_state, ts = base.step(env_state, act.reshape(A, -1),
                                      self.base_key, self.env_ids,
                                      self.env_params, self.spec)
            total = total + torch.where(done_seen, 0.0, ts.reward)
            done_seen = done_seen | ts.done
            obs = ts.obs
        return env_state, obs, h, total, done_seen

    def __call__(self, genome: Genome, episode, graphed=None):
        genome, carry = self.start(genome, episode)
        if graphed is None:
            graphed = genome.w_dir.is_cuda
        with torch.no_grad():
            if graphed:
                for _ in range(self.cfg.max_steps):
                    carry = self.graph(genome, *carry)
                    genome = self.graph.inputs[0]
            else:
                carry = self.steps(genome, *carry, n=self.cfg.max_steps)
        per_episode = carry[3].reshape(self.p, self.R)
        out = per_episode if self.return_episodes else per_episode.mean(1)
        if self.group is not None:
            out = sharding.gather_columns(out.movedim(0, -1),
                                          self.group).movedim(-1, 0)
        return out.clone()


def make_fitness_fn(env_name: str, cfg: NeatConfig,
                    env_params: Optional[EnvParams] = None,
                    reps: Optional[int] = None, seed: int = 1000,
                    group=None, return_episodes: bool = False,
                    device=None) -> Fitness:
    """fitness(genome, episode) -> (P,) mean first-episode return over
    `reps` fresh environments per genome, the whole population as one env
    batch of P * reps (key PRNGKey(seed); `episode` indexes the reset
    randomness, so each generation sees fresh wind kicks).  Runs on the
    card unless device='cpu'.

    With a process `group`, rank r of W evaluates genomes [r·P/W,
    (r+1)·P/W) on the envs of those global ids, and every rank returns the
    whole (P,) fitness; W must divide pop_size."""
    return Fitness(env_name, cfg, env_params, reps, seed, group,
                   return_episodes, device)


def _tournament(key, fit, P: int, size: int, bits: int):
    idx = prng.randint(key, (P, size), 0, P, bits).to(fit.device)
    return idx[torch.arange(P, device=fit.device),
               torch.argmax(fit[idx], dim=1)]


def keep_elites(child, parent, fit, n_elite: int):
    """The child population with its first n_elite slots replaced by the
    n_elite fittest parents (stable order on ties, as `jnp.argsort`)."""
    P = fit.shape[0]
    elite = torch.argsort(-fit, stable=True)[:n_elite]
    slot = torch.arange(P, device=fit.device)
    src = torch.where(slot < n_elite,
                      elite[torch.clamp_max(slot, n_elite - 1)], slot)
    keep = slot < n_elite

    def pick(c, g):
        mask = keep.reshape((P,) + (1,) * (g.ndim - 1))
        return torch.where(mask, g[src], c)

    return tree_map(pick, child, parent)


def parents(cfg, fit, key, dtype):
    """(k_mut, pa, pb, use_cx): the mutation key, two tournament winners
    per child and the crossover flags, drawn as the JAX modules draw
    them."""
    P, bits = cfg.pop_size, index_bits(dtype)
    k_pa, k_pb, k_cx, k_mut = prng.split(key, 4)
    pa = _tournament(k_pa, fit, P, cfg.tournament, bits)
    pb = _tournament(k_pb, fit, P, cfg.tournament, bits)
    use_cx = prng.bernoulli(k_cx, cfg.crossover_rate, (P,), dtype)
    return k_mut, pa, pb, use_cx


def crossover(keys, x, pa, pb, use_cx, dtype):
    """Gene-level crossover of x (P, ...): each gene from parent b where a
    fair coin and the child's crossover flag say so, else from a."""
    pick_b = (prng.bernoulli(next(keys), 0.5, x.shape, dtype)
              & use_cx.reshape((-1,) + (1,) * (x.ndim - 1)))
    return pick_b, torch.where(pick_b, x[pb], x[pa])


def mutate_weights(keys, w, cfg, dtype):
    """Perturb or replace each weight (one uniform r: r < rate perturbs,
    else r < rate + replace_rate replaces), then clip."""
    r = prng.uniform(next(keys), w.shape, dtype=dtype)
    perturb = r < cfg.weight_mutate_rate
    replace = (~perturb) & (r < cfg.weight_mutate_rate
                            + cfg.weight_replace_rate)
    w = w + torch.where(perturb, cfg.weight_mutate_power
                        * prng.normal(next(keys), w.shape, dtype), 0.0)
    w = torch.where(replace, cfg.weight_init_stdev
                    * prng.normal(next(keys), w.shape, dtype), w)
    return torch.clamp(w, -cfg.weight_clip, cfg.weight_clip)


def mutate_bias(keys, b, pa, pb, use_cx, cfg, dtype):
    """Crossover, Gaussian perturbation at the mutate rate, clip."""
    _, cb = crossover(keys, b, pa, pb, use_cx, dtype)
    cb = cb + torch.where(
        prng.bernoulli(next(keys), cfg.weight_mutate_rate, b.shape, dtype),
        cfg.weight_mutate_power * prng.normal(next(keys), b.shape, dtype),
        0.0)
    return torch.clamp(cb, -cfg.weight_clip, cfg.weight_clip)


def make_evolve_fn(cfg: NeatConfig):
    """evolve(genome, fit, key) -> next generation: elitism (the n_elite
    fittest copied verbatim into slots 0..E-1), tournament parents,
    gene-level crossover with weight and enable bit travelling together,
    weight mutation, and mask mutation of the hidden block (expected
    `conn_enable_per_child` bits on, `conn_disable_per_child` off).  Runs
    eagerly on the genome's device; key is a (2,) key there."""

    def evolve(genome: Genome, fit, key) -> Genome:
        dtype = genome.w_dir.dtype
        k_mut, pa, pb, use_cx = parents(cfg, fit, key, dtype)
        keys = iter(prng.split(k_mut, 7 * len(_PAIRS) + 3 * len(_BIASES)))
        out = {}
        for wname, mname in _PAIRS:
            w, m = getattr(genome, wname), getattr(genome, mname)
            n_conn = w[0].numel()
            pick_b, cw = crossover(keys, w, pa, pb, use_cx, dtype)
            cm = torch.where(pick_b, m[pb], m[pa])
            cw = mutate_weights(keys, cw, cfg, dtype)
            # the direct block stays NEAT's always-present genes
            if mname != 'm_dir':
                enable = prng.bernoulli(
                    next(keys), cfg.conn_enable_per_child / n_conn, m.shape,
                    dtype)
                disable = prng.bernoulli(
                    next(keys), cfg.conn_disable_per_child / n_conn,
                    m.shape, dtype)
                cm = torch.clamp(cm + enable.to(dtype) - disable.to(dtype),
                                 0.0, 1.0)
            out[wname], out[mname] = cw, cm
        for bname in _BIASES:
            out[bname] = mutate_bias(keys, getattr(genome, bname), pa, pb,
                                     use_cx, cfg, dtype)
        return keep_elites(Genome(**out), genome, fit, cfg.n_elite)

    return evolve


def take_genome(genome, i):
    """Genome i with a pop axis of 1."""
    return tree_map(lambda g: g[i][None], genome)


def take_genomes(genome, idx):
    """Genomes idx (k,) as a population of k."""
    return tree_map(lambda g: g[idx], genome)


def run_generations(fitness, holdout, evolve, population, cfg, key,
                    max_generations, log_every, callback, record):
    """The generation loop shared with learn/hyperneat.py: train fitness,
    top-k holdout re-scoring, champion by best holdout, the stopping rule,
    evolution.  `record(population, gen, fit, best, mean, holdout)` makes
    the history entry.  Returns (champion, history, population)."""
    history, best_ever, champion = [], -float('inf'), None
    train_threshold_gen = None
    for gen in range(max_generations):
        fit = fitness(population, gen)
        best_i = int(torch.argmax(fit))
        best, mean = float(fit[best_i]), float(fit.mean())
        topk_i = torch.argsort(-fit, stable=True)[:cfg.topk]
        cands = take_genomes(population, topk_i)
        ho = holdout(cands, 2 ** 30)
        ho_best_i = int(torch.argmax(ho))
        ho_best = float(ho[ho_best_i])
        rec = record(population, gen, best, mean, ho_best)
        if best >= cfg.fitness_threshold and train_threshold_gen is None:
            train_threshold_gen = gen
            rec['train_threshold_reached'] = True
        history.append(rec)
        if ho_best > best_ever:
            best_ever = ho_best
            champion = take_genome(cands, ho_best_i)
        if callback is not None:
            callback(rec)
        elif gen % log_every == 0:
            print(f'gen {gen:4d}  best {best:8.1f}  mean {mean:8.1f}  '
                  f'holdout {ho_best:8.1f}'
                  + (f'  hidden-conn {rec["hidden_conn_frac"]:.3f}'
                     if 'hidden_conn_frac' in rec else ''), flush=True)
        if (best >= cfg.fitness_threshold
                and best_ever >= cfg.fitness_threshold + cfg.holdout_margin):
            break
        key, k = prng.split(key)
        population = evolve(population, fit, k)
    return champion, history, population


def evolve_population(env_name: str = 'Lander2D-v0',
                      cfg: NeatConfig = NeatConfig(),
                      env_params: Optional[EnvParams] = None,
                      max_generations: int = 500, seed: int = 0,
                      eval_seed: int = 1000, log_every: int = 10,
                      callback=None, group=None, device=None,
                      dtype=torch.float32):
    """The NEAT-Gym `neat-evolve.py` equivalent: evolve until the best
    train fitness reaches fitness_threshold and the champion's holdout
    clears it by holdout_margin, or max_generations.  Each generation's
    top-k genomes are re-scored on a fixed holdout (seed eval_seed + 1,
    episode 2**30, holdout_reps episodes) and the champion is the best
    held-out genome of all generations.  Runs on the card unless
    device='cpu'; `group` shards the train fitness.

    Returns (champion Genome (pop axis 1), history of per-generation dicts,
    final population)."""
    device = resolve_device(device)
    spec, env_params = resolve_params(env_name, env_params)
    fitness = make_fitness_fn(env_name, cfg, env_params, seed=eval_seed,
                              group=group, device=device)
    holdout = make_fitness_fn(
        env_name, dataclasses.replace(cfg, pop_size=cfg.topk), env_params,
        reps=cfg.holdout_reps, seed=eval_seed + 1, device=device)
    key, k0 = prng.split(prng.PRNGKey(seed, device))
    genome = init_population(k0, spec.obs_size, spec.action_size, cfg, dtype)

    def record(g, gen, best, mean, ho_best):
        enabled = float(g.m_in.mean() + g.m_rec.mean()
                        + g.m_out.mean()) / 3.0
        return {'generation': gen, 'best_fitness': best, 'mean_fitness': mean,
                'holdout_best': ho_best, 'hidden_conn_frac': enabled}

    return run_generations(fitness, holdout, make_evolve_fn(cfg), genome,
                           cfg, key, max_generations, log_every, callback,
                           record)


def evaluate_champion(champion: Genome, env_name: str, cfg: NeatConfig,
                      env_params: Optional[EnvParams] = None,
                      reps: int = 100, seed: int = 77, episode: int = 10000,
                      graphed=None):
    """The champion on `reps` fresh episodes (the NEAT-Gym `neat-test.py`
    role), on its device.  Returns (mean, per-episode returns (reps,))."""
    one = dataclasses.replace(cfg, pop_size=1)
    fn = make_fitness_fn(env_name, one, env_params, reps=reps, seed=seed,
                         return_episodes=True, device=champion.w_dir.device)
    per_episode = fn(champion, episode, graphed)[0]
    return float(per_episode.mean()), per_episode
