#!/usr/bin/env python3
"""Prefix each line of standard input with the seconds since this script
started, so that a long run's output shows where its time went:

    python3 -u chip_smoke.py 2>&1 | python3 tools/stamp_lines.py

Two runs stamped so can be compared phase by phase."""

import sys
import time


def main() -> int:
    t0 = time.time()
    for line in sys.stdin:
        sys.stdout.write(f"{time.time() - t0:8.1f} {line}")
        sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
