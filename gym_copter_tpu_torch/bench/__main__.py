"""`python -m gym_copter_tpu_torch.bench`: the headline bench (bench.py's
counterpart, headline.py)."""

import sys

from gym_copter_tpu_torch.bench.headline import main

if __name__ == '__main__':
    sys.exit(main())
