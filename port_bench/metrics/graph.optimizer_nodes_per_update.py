"""CUDA graph nodes of the optimizer in one PPO update: the program's
recorder's `ppo.optimizer` regions (clip, Adam, the target-KL selects and
the parameter update; one per minibatch, summed) at its own capture of
the graph `ppo.update`."""

from port_bench import spans


def read(layers):
    if layers.get('loop') != 'train':
        return None
    return spans.region_nodes('ppo.update', ('ppo.optimizer',))
