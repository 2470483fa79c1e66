"""Device-performance attribution (port of ome_tpu/perf).

Three always-on, cheap observability surfaces that read a live replica
on the card:

  * ledger  — per-program cost ledger (FLOPs counted at the first
              dispatch of each program key, modelled bytes, expected
              roofline ms), served at GET /debug/programs;
  * hbm     — live device memory partitioned against the known
              tenants (weights / KV cache / prefix cache / workspace),
              with a new-peak watermark flight event;
  * the scheduler combines the ledger's bytes-per-step with its own
    step timestamps into an online roofline-efficiency signal and a
    slow-step outlier detector (engine/scheduler.py).
"""

from .hbm import HBM_TENANTS, HbmAccountant
from .ledger import (DEVICE_HBM_GBPS, DEVICE_PEAK_TFLOPS, ProgramLedger,
                     device_spec, roofline_ms)

__all__ = [
    "DEVICE_HBM_GBPS", "DEVICE_PEAK_TFLOPS", "HBM_TENANTS",
    "HbmAccountant", "ProgramLedger", "device_spec", "roofline_ms",
]
