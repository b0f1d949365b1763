#!/usr/bin/env python
"""3-D harris throughput over the standard tiers, in one process (the tiers
share the persistent compile cache): one bench.py JSON line per tier.

Usage: bench3d.py
"""

import json
import sys

sys.path.insert(0, __file__.rsplit("/", 2)[0])

TIERS = ((32, 32, 32), (32, 32, 128), (64, 64, 16))


def main():
    import bench
    bench.require_gpu()
    for nx, nz, nppc in TIERS:
        print(json.dumps(bench.run_deck("harris3d", [nx, nz, nppc])),
              flush=True)


if __name__ == "__main__":
    main()
