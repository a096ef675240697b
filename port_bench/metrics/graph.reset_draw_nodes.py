"""CUDA graph nodes of the env step's auto-reset draw (the fresh state and
its threefry draw, envs/base.py `reset` inside `step`) inside the PPO
rollout's one-step graph: the program's recorder's region `env.reset_draw`
at its own capture of the graph `ppo.rollout_step`."""

from port_bench import spans


def read(layers):
    if layers.get('loop') != 'train':
        return None
    return spans.region_nodes('ppo.rollout_step', ('env.reset_draw',))
