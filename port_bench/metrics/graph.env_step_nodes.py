"""CUDA graph nodes of one env step inside the PPO rollout's one-step
graph: the nodes that the program's recorder counted in its regions
`env.transition`, `env.reset_draw` and `env.select` (envs/base.py `step`)
at the program's own capture of the graph `ppo.rollout_step`."""

from port_bench import spans

REGIONS = ('env.transition', 'env.reset_draw', 'env.select')


def read(layers):
    if layers.get('loop') != 'train':
        return None
    return spans.region_nodes('ppo.rollout_step', REGIONS)
