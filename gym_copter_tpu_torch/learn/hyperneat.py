"""HyperNEAT on torch: CPPN-generated substrate networks, the counterpart
of `gym_copter_tpu/learn/hyperneat.py`, whose docstring gives the design,
its sources in the reference (attic/neat/config) and its documented
deviations from ES-HyperNEAT.

A CPPN maps a connection's endpoint coordinates (x1, y1, x2, y2) to its
weight; querying every genome's CPPN at every connection of the fixed
substrate is one population-stacked product over a (Q, 4) coordinate
table.  The decoded phenotype is a `neuroevolution.Genome`, evaluated by
the same (graphed) fitness function; decoding runs eagerly once per
generation.  The substrate's coordinates have JAX's `linspace` bits
(core/device.py), and `evolve` draws as the JAX module does, in its key
order.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from gym_copter_tpu_torch.core import prng
from gym_copter_tpu_torch.core.device import linspace, resolve_device
from gym_copter_tpu_torch.envs import tasks
from gym_copter_tpu_torch.learn import neuroevolution as ne


class CPPNGenome(NamedTuple):
    """Population-stacked CPPN genomes (leading axis = pop): a one-hidden-
    layer network 4 -> C -> 7 (six weight channels, one per substrate
    block, and an expression channel) with maskable connections and a
    per-node activation."""

    w_in: torch.Tensor     # (P, C, 4)
    m_in: torch.Tensor
    w_out: torch.Tensor    # (P, 7, C)
    m_out: torch.Tensor
    b_h: torch.Tensor      # (P, C)
    b_out: torch.Tensor    # (P, 7)
    act_sel: torch.Tensor  # (P, C) int32 in {0 gauss, 1 sin, 2 tanh}


_N_OUT = 7


class Substrate(NamedTuple):
    inputs: torch.Tensor   # (I, 2)
    hidden: torch.Tensor   # (H, 2)
    outputs: torch.Tensor  # (A, 2)


def make_substrate(obs_size: int, action_size: int, n_hidden: int = 8,
                   dtype=torch.float32, device=None) -> Substrate:
    """Inputs on y = -1 spanning [-1, 1], hidden on y = 0 inside
    [-0.5, 0.5], motors on the x = +1 edge."""
    device = resolve_device(device)

    def line(lo, hi, n, other, other_first):
        xs = linspace(lo, hi, n, dtype, device)
        c = torch.full((n,), other, dtype=dtype, device=device)
        return torch.stack([c, xs] if other_first else [xs, c], dim=1)

    return Substrate(inputs=line(-1.0, 1.0, obs_size, -1.0, False),
                     hidden=line(-0.5, 0.5, n_hidden, 0.0, False),
                     outputs=line(-1.0, 1.0, action_size, 1.0, True))


@dataclasses.dataclass(frozen=True)
class HyperNeatConfig:
    """The JAX package's HyperNeatConfig, field for field."""

    pop_size: int = 96
    episode_reps: int = 10
    fitness_threshold: float = 300.0
    cppn_hidden: int = 16
    substrate_hidden: int = 8
    n_elite: int = 2
    tournament: int = 3
    crossover_rate: float = 0.75
    weight_mutate_rate: float = 0.8
    weight_mutate_power: float = 0.5
    weight_replace_rate: float = 0.1
    weight_init_stdev: float = 1.0
    weight_clip: float = 8.0
    activation_mutate_rate: float = 0.5
    conn_toggle_per_child: float = 1.0
    max_weight: float = 8.0
    express_threshold: float = 0.3
    action_anchor: str = 'hover'
    max_steps: int = 999
    topk: int = 4
    holdout_reps: int = 32
    holdout_margin: float = 10.0

    def as_neat(self) -> ne.NeatConfig:
        """The phenotype-side view, for the shared fitness machinery."""
        return ne.NeatConfig(
            pop_size=self.pop_size, episode_reps=self.episode_reps,
            fitness_threshold=self.fitness_threshold,
            hidden=self.substrate_hidden, action_anchor=self.action_anchor,
            max_steps=self.max_steps, topk=self.topk,
            holdout_reps=self.holdout_reps,
            holdout_margin=self.holdout_margin)


def init_cppn_population(key, cfg: HyperNeatConfig,
                         dtype=torch.float32) -> CPPNGenome:
    """NEAT's minimal start: one enabled CPPN hidden unit, the rest masked
    off; on key's device."""
    P, C = cfg.pop_size, cfg.cppn_hidden
    ks = prng.split(key, 5)
    std = cfg.weight_init_stdev
    m_in = torch.zeros((P, C, 4), dtype=dtype, device=key.device)
    m_in[:, 0, :] = 1.0
    m_out = torch.zeros((P, _N_OUT, C), dtype=dtype, device=key.device)
    m_out[:, :, 0] = 1.0
    return CPPNGenome(
        w_in=std * prng.normal(ks[0], (P, C, 4), dtype), m_in=m_in,
        w_out=std * prng.normal(ks[1], (P, _N_OUT, C), dtype), m_out=m_out,
        b_h=std * prng.normal(ks[2], (P, C), dtype),
        b_out=std * prng.normal(ks[3], (P, _N_OUT), dtype),
        act_sel=prng.randint(ks[4], (P, C), 0, 3,
                             ne.index_bits(dtype)).to(torch.int32))


def _cppn_forward(cppn: CPPNGenome, coords):
    """Every genome's CPPN at every coordinate row: coords (Q, 4) ->
    (P, 7, Q).  Each hidden node applies its selected activation."""
    z = (torch.einsum('pcf,qf->pcq', cppn.w_in * cppn.m_in, coords)
         + cppn.b_h[:, :, None])
    sel = cppn.act_sel[:, :, None]
    h = torch.where(sel == 0, torch.exp(-z * z),
                    torch.where(sel == 1, torch.sin(z), torch.tanh(z)))
    return (torch.einsum('poc,pcq->poq', cppn.w_out * cppn.m_out, h)
            + cppn.b_out[:, :, None])


def _pairs(a, b):
    """(Na, 2) x (Nb, 2) -> (Na * Nb, 4) coordinate table, row-major in
    a."""
    na, nb = a.shape[0], b.shape[0]
    return torch.cat([torch.repeat_interleave(a, nb, dim=0),
                      b.repeat(na, 1)], dim=1)


def make_decoder(substrate: Substrate, cfg: HyperNeatConfig):
    """decode(cppn) -> phenotype `neuroevolution.Genome`: one CPPN sweep
    over the concatenated query table makes every block; weights are
    max_weight * tanh, and a connection is expressed where |tanh| of the
    expression channel exceeds express_threshold.  Biases are queried at
    (node, origin)."""
    inp, hid, out = substrate.inputs, substrate.hidden, substrate.outputs
    I, H, A = inp.shape[0], hid.shape[0], out.shape[0]
    origin = torch.zeros((1, 2), dtype=inp.dtype, device=inp.device)
    table = torch.cat([_pairs(inp, hid), _pairs(hid, hid), _pairs(hid, out),
                       _pairs(inp, out), _pairs(hid, origin),
                       _pairs(out, origin)], dim=0)
    sizes = [I * H, H * H, H * A, I * A, H, A]
    s = [0]
    for n in sizes:
        s.append(s[-1] + n)

    def decode(cppn: CPPNGenome) -> ne.Genome:
        raw = _cppn_forward(cppn, table)      # (P, 7, Q)
        P = raw.shape[0]
        w = cfg.max_weight * torch.tanh(raw[:, :6, :])
        express = torch.abs(torch.tanh(raw[:, 6, :])) > cfg.express_threshold

        def block(i, shape):
            # channel i's queries are (src, dst) row-major in src; Genome
            # blocks are (dst, src)
            ws = w[:, i, s[i]:s[i + 1]].reshape((P,) + shape)
            ms = express[:, s[i]:s[i + 1]].reshape((P,) + shape)
            return (ws.transpose(1, 2).contiguous(),
                    ms.transpose(1, 2).to(ws.dtype).contiguous())

        w_in, m_in = block(0, (I, H))
        w_rec, m_rec = block(1, (H, H))
        w_out, m_out = block(2, (H, A))
        w_dir, m_dir = block(3, (I, A))
        return ne.Genome(w_dir=w_dir, m_dir=m_dir, w_in=w_in, m_in=m_in,
                         w_rec=w_rec, m_rec=m_rec, w_out=w_out, m_out=m_out,
                         b_h=w[:, 4, s[4]:s[5]].contiguous(),
                         b_out=w[:, 5, s[5]:s[6]].contiguous())

    return decode


def make_evolve_fn(cfg: HyperNeatConfig):
    """CPPN evolution: the direct GA's operators (tournament, gene-level
    crossover, weight perturb/replace/clip), each connection's mask bit
    toggled at `conn_toggle_per_child` expected bits per child, and each
    node's activation crossed over and re-rolled at
    `activation_mutate_rate`."""

    def evolve(cppn: CPPNGenome, fit, key) -> CPPNGenome:
        dtype = cppn.w_in.dtype
        k_mut, pa, pb, use_cx = ne.parents(cfg, fit, key, dtype)
        keys = iter(prng.split(k_mut, 24))
        out = {}
        for wname, mname in (('w_in', 'm_in'), ('w_out', 'm_out')):
            w, m = getattr(cppn, wname), getattr(cppn, mname)
            n_conn = w[0].numel()
            pick_b, cw = ne.crossover(keys, w, pa, pb, use_cx, dtype)
            cm = torch.where(pick_b, m[pb], m[pa])
            cw = ne.mutate_weights(keys, cw, cfg, dtype)
            toggle = prng.bernoulli(next(keys),
                                    cfg.conn_toggle_per_child / n_conn,
                                    m.shape, dtype)
            out[wname] = cw
            out[mname] = torch.where(toggle, 1.0 - cm, cm)
        for bname in ('b_h', 'b_out'):
            out[bname] = ne.mutate_bias(keys, getattr(cppn, bname), pa, pb,
                                        use_cx, cfg, dtype)
        _, a = ne.crossover(keys, cppn.act_sel, pa, pb, use_cx, dtype)
        re_roll = prng.bernoulli(next(keys), cfg.activation_mutate_rate,
                                 a.shape, dtype)
        out['act_sel'] = torch.where(
            re_roll, prng.randint(next(keys), a.shape, 0, 3,
                                  ne.index_bits(dtype)).to(a.dtype), a)
        return ne.keep_elites(CPPNGenome(**out), cppn, fit, cfg.n_elite)

    return evolve


def evolve_population(env_name: str = 'Lander2D-v0',
                      cfg: HyperNeatConfig = HyperNeatConfig(),
                      env_params=None, max_generations: int = 500,
                      seed: int = 0, eval_seed: int = 1000,
                      log_every: int = 10, callback=None, device=None,
                      dtype=torch.float32):
    """The HyperNEAT run loop: evolve CPPNs, score their decoded substrate
    phenotypes with the shared fitness machinery, champion by top-k fixed
    holdout re-scoring (as neuroevolution.evolve_population).  Runs on the
    card unless device='cpu'.  Returns (champion CPPNGenome with pop axis
    1, history, final population)."""
    device = resolve_device(device)
    spec = tasks.ALL_TASKS[env_name]
    neat_cfg = cfg.as_neat()
    decode = make_decoder(make_substrate(spec.obs_size, spec.action_size,
                                         cfg.substrate_hidden, dtype,
                                         device), cfg)
    fitness_pheno = ne.make_fitness_fn(env_name, neat_cfg, env_params,
                                       seed=eval_seed, device=device)
    holdout_pheno = ne.make_fitness_fn(
        env_name, dataclasses.replace(neat_cfg, pop_size=cfg.topk),
        env_params, reps=cfg.holdout_reps, seed=eval_seed + 1, device=device)
    key, k0 = prng.split(prng.PRNGKey(seed, device))
    cppn = init_cppn_population(k0, cfg, dtype)

    def record(_, gen, best, mean, ho_best):
        return {'generation': gen, 'best_fitness': best,
                'mean_fitness': mean, 'holdout_best': ho_best}

    return ne.run_generations(lambda c, ep: fitness_pheno(decode(c), ep),
                              lambda c, ep: holdout_pheno(decode(c), ep),
                              make_evolve_fn(cfg), cppn,
                              cfg, key, max_generations, log_every, callback,
                              record)


def evaluate_champion(champion: CPPNGenome, env_name: str,
                      cfg: HyperNeatConfig, env_params=None,
                      reps: int = 100, seed: int = 77, episode: int = 10000,
                      graphed=None):
    """The decoded champion on `reps` fresh episodes, on its device, as
    neuroevolution.evaluate_champion.  Returns (mean, per-episode returns
    (reps,))."""
    spec = tasks.ALL_TASKS[env_name]
    device = champion.w_in.device
    decode = make_decoder(make_substrate(
        spec.obs_size, spec.action_size, cfg.substrate_hidden,
        champion.w_in.dtype, device), cfg)
    return ne.evaluate_champion(decode(champion), env_name, cfg.as_neat(),
                                env_params, reps, seed, episode, graphed)
