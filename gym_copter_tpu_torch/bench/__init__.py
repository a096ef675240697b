"""The measurement entry points of the port, the counterparts of the JAX
package's `bench.py`, `scripts/bench_train.py`,
`scripts/bench_batch_sweep.py`, `scripts/bench_vision.py`,
`scripts/bench_scaling.py` and `scripts/profile_ppo.py`:

    python -m gym_copter_tpu_torch.bench                  # headline.py
    python -m gym_copter_tpu_torch.bench.batch_sweep [--out ...]
    python -m gym_copter_tpu_torch.bench.train [--out ...]
    python -m gym_copter_tpu_torch.bench.profile_ppo [--out ...]
    python -m gym_copter_tpu_torch.bench.vision [--out ...]
    python -m gym_copter_tpu_torch.bench.scaling [--out ...]

Each measures what its JAX script measures, on the port's paths at the
script's default sizes, and prints its JSON in the script's schema plus
the card it ran on (`utils/profiling.card`).  They run on the card only:
without one they raise and exit non-zero, with no fallback.  Their
records go to `docs/torch_bench_*.json`.  The functions take `device=` so
that the tests run them on the CPU at small sizes.
"""
