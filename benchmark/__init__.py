"""The benchmark of ``crafter_tpu_torch``: ``python3 benchmark/run.py
--workload <name> --seed <n> --seconds <s> --trace <0|1>``."""
