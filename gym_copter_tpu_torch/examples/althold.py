"""Drop the vehicle and test altitude hold: the counterpart of
examples/althold.py (the reference's attic/examples/althold.py, a thin
shim over the pidctrl runner, :10-12).

    python -m gym_copter_tpu_torch.examples.althold [--save althold.png]
"""

from gym_copter_tpu_torch.examples.pidctrl import main

if __name__ == '__main__':
    main()
