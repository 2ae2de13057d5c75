"""The harness's CPU tests: the benchmark's directory and the repository's
root on the path, as `benchmark/run.py` puts them."""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH = os.path.dirname(HERE)
for p in (BENCH, os.path.dirname(BENCH)):
    if p not in sys.path:
        sys.path.insert(0, p)
