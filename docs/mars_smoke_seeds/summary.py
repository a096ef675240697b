"""The Mars learning smoke's gain (best evaluation minus the first) per
seed in each record of this directory, grouped by run (the file name
before its seed range), with each run's median, least and count of seeds
at or below tests/test_mars.py's bar of 40.

    python docs/mars_smoke_seeds/summary.py
"""

import json
import statistics
from collections import defaultdict
from pathlib import Path

BAR = 40.0


def main():
    gains = defaultdict(dict)
    for path in sorted(Path(__file__).resolve().parent.glob('*.json')):
        run = path.stem.rsplit('_', 1)[0]
        for r in json.loads(path.read_text())['runs']:
            gains[run][r['seed']] = (r['best_eval_return']
                                     - r['first_eval_return'])
    for run, by_seed in sorted(gains.items()):
        g = [by_seed[s] for s in sorted(by_seed)]
        low = {s: round(v, 2) for s, v in sorted(by_seed.items())
               if v <= BAR}
        print(json.dumps({
            'run': run, 'seeds': f'{min(by_seed)}-{max(by_seed)}',
            'n': len(g), 'median': round(statistics.median(g), 2),
            'least': round(min(g), 2), 'at_or_below_bar': len(low),
            'low_seeds': low,
            'gains': {s: round(v, 2) for s, v in sorted(by_seed.items())}}))


if __name__ == '__main__':
    main()
