"""speedbench: the benchmark of radtts_tpu_torch (see run.py)."""
