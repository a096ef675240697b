import sys

from port_bench.harness import main

sys.exit(main())
