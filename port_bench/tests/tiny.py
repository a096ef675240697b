"""Each cell shrunk to a size a CPU test run holds (the overrides that
`harness.run` merges into its configuration and traffic)."""

_PPO = {'config': {'num_envs': 16,
                   'ppo': {'rollout_steps': 8, 'hidden': 16,
                           'minibatches': 2, 'epochs': 2,
                           'shuffle_block': 1}},
        'traffic': {'warmup': {'min_s': 0.05, 'max_s': 0.2}}}

CELLS = {
    'lander3d.ppo': _PPO,
    'hover3d.ppo': _PPO,
    'lander3d.fused': {'traffic': {'num_envs': 128, 'steps_per_call': 20,
                                   'warmup_calls': 1}},
    'lander3d.single': {'traffic': {'warmup': {'min_s': 0.05,
                                               'max_s': 0.2},
                                    'checked_episodes': 3}},
}
SEED = 2 ** 31 + 77
