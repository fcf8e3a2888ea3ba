"""servebench: the benchmark of the port (``repro_torch``); see run.py."""
