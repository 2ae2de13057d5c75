"""The benchmark of pfv_torch on NVIDIA H100 cards; see benchmark/README.md.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import os
import sys

if __name__ == "__main__":
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    # the harness and the reference import as top-level packages; the
    # program from the checkout's root
    sys.path[:0] = [here, root]
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(here, ".cache", sub))
    from harness.main import main

    sys.exit(main())
