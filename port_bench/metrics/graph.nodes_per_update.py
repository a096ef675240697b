"""CUDA graph nodes that one PPO update replays: the nodes of the one-step
rollout graph times the rollout's length, plus the GAE graph's and the
update graph's, each counted by CUDA's cuGraphGetNodes on a capture
of the train step's phase."""


def read(layers):
    g = layers.get('graph_nodes')
    if not g:
        return None
    return (g['rollout_step'][0] * g['rollout_steps'] + g['gae'][0]
            + g['update'][0])
