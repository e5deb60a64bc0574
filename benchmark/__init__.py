"""The benchmark of metaasr_tpu_torch: ``python3 -m benchmark.run``."""
