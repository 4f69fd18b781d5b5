"""The benchmark of ``loans_tpu_torch`` on one NVIDIA H100 (see ``run.py``).

Everything here is the yardstick: traffic generation, the reduction from
traces to metrics, the table of peaks, the operation and byte counts, the
plain reference of each configuration and the comparison that decides
``correct``. From the program it takes only the system under test.
"""
