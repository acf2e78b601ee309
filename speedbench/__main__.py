"""python3 -m speedbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1> (see speedbench/run.py)."""

import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# every build and kernel cache inside the checkout, at fixed paths
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(_ROOT, "build",
                                                  "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(_ROOT, "build", "triton")
os.environ.setdefault("USE_FLAX", "0")

from speedbench.run import main  # noqa: E402

sys.exit(main())
