"""Do the CPU's torch.sqrt and torch.erfinv give the same bits in every
fresh process while the CPU is loaded?  And the port's `prng.normal`?

    python tests/torch_mkl_race.py [--runs 40]

On the CPU torch computes `sqrt`, `erfinv`, `exp`, `sin`, ... through MKL's
vector library (ATen/cpu/vml.h).  This script loads the CPU with the port's
PPO tests (tests/test_torch_ppo.py and test_torch_ppo_train.py, as a test
worker beside this one would), and meanwhile starts `--runs` fresh
processes one after another, each making one first call of: torch.sqrt of
400,000 float32 values (counting the results that differ from numpy's
correctly rounded square root), torch.erfinv of 400,000 values, and
`prng.normal(PRNGKey(42), (4, 100000))` in float32; it prints how many
processes gave bits other than the first process's, and the largest count
of wrong square roots.  Not a test: its answer depends on the machine's
load.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = r'''
import hashlib, json, sys
import numpy as np, torch
sys.path.insert(0, sys.argv[1])
from gym_copter_tpu_torch.core import prng
g = torch.Generator().manual_seed(0)
w = torch.rand(400000, generator=g) * 10 + 0.01
sq = torch.sqrt(w).numpy()
exact = np.sqrt(w.numpy().astype(np.float64)).astype(np.float32)
inv = torch.erfinv(w / 10.02 * 2 - 1).numpy()
nrm = prng.normal(prng.PRNGKey(42, 'cpu'), (4, 100000)).numpy()
h = lambda a: hashlib.sha256(a.tobytes()).hexdigest()[:12]
print(json.dumps({'sqrt': h(sq), 'sqrt_wrong': int((sq != exact).sum()),
                  'erfinv': h(inv), 'normal': h(nrm)}))
'''


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument('--runs', type=int, default=40)
    args = ap.parse_args(argv)
    load = subprocess.Popen(
        [sys.executable, '-m', 'pytest', '-q', '-p', 'no:cacheprovider',
         'tests/test_torch_ppo.py', 'tests/test_torch_ppo_train.py'],
        cwd=ROOT, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    try:
        results = [json.loads(subprocess.run(
            [sys.executable, '-c', PROBE, ROOT], check=True, text=True,
            capture_output=True, timeout=300).stdout)
            for _ in range(args.runs)]
    finally:
        load.kill()
        load.wait()
    first = results[0]
    report = {k: sum(r[k] != first[k] for r in results)
              for k in ('sqrt', 'erfinv', 'normal')}
    report['runs'] = args.runs
    report['sqrt_wrong'] = sorted({r['sqrt_wrong'] for r in results})
    print(json.dumps(report))


if __name__ == '__main__':
    main()
