"""Live device-memory accounting: who owns the card's memory right now.

Port of ome_tpu/perf/hbm.py. The allocator gives the truth (bytes in
use, peak, limit); the engine knows its own tenants — weights (the
quantizer's byte model), KV cache (pool capacity in paged mode, the
dense slab otherwise), prefix cache (its own byte counter). The
residual is workspace: activations, sampling and scratch buffers, and
the caching allocator's slack. Partitioning the allocator number
against the tenants turns "the card is 93% full" into "weights 41%, KV
38%, prefix 6%, workspace 8%".

On a CUDA device the allocator numbers come from
`torch.cuda.memory_stats(device)`: `bytes_in_use` is
`reserved_bytes.all.current` (the segments the caching allocator has
reserved from CUDA, so its slack lands in `workspace`, as XLA's
fragmentation does in the reference), the peak is
`reserved_bytes.all.peak`, and the limit is the card's total from
`torch.cuda.mem_get_info`, read once. None of these reads synchronizes
the device.

A new allocator peak records an `hbm_peak` watermark event in the
flight ring, carrying the partition at that moment.

Off the card there are no allocator numbers; the gauges then carry the
tenant model alone (in_use = sum of known tenants, workspace 0) so
dashboards keep a consistent shape in dev environments.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

# fixed tenant enum: gauge children are pre-created for exactly this
# set, so label cardinality is bounded by construction
HBM_TENANTS = ("weights", "kv_cache", "prefix_cache", "workspace")


def kv_capacity_bytes(engine) -> int:
    """Device bytes of the engine's KV allocation: the paged pool
    (kv_blocks x kv_block rows) or the dense [L, B, S] slab, at the
    engine's own per-row byte model (`kv_row_bytes`, int8-pool
    aware)."""
    row = int(engine.kv_row_bytes())
    if getattr(engine, "kv_block", 0):
        return int(engine.kv_blocks * engine.kv_block * row)
    return int(engine.max_slots * engine.max_seq * row)


class HbmAccountant:
    """Scrape-time device-memory gauges partitioned against the known
    tenants.

    `stats_fn` overrides the allocator read (tests inject allocator
    numbers); None reads `torch.cuda.memory_stats` for a CUDA `device`
    and nothing for any other, which falls back to the tenant model.
    """

    def __init__(self, registry, weight_bytes: int = 0, device=None,
                 flight=None, stats_fn=None):
        self.weight_bytes = int(weight_bytes)
        self.flight = flight
        self._stats_fn = stats_fn
        self._device = None if device is None else torch.device(device)
        self._limit: Optional[float] = None
        self._last_peak = 0.0
        self._g_in_use = registry.gauge(
            "ome_engine_hbm_bytes_in_use",
            "Device bytes in use (the CUDA caching allocator's reserved "
            "bytes on a card; the tenant model's sum off the card)")
        self._g_limit = registry.gauge(
            "ome_engine_hbm_bytes_limit",
            "Device memory limit reported by the allocator (0 when "
            "unavailable)")
        self._g_peak = registry.gauge(
            "ome_engine_hbm_peak_bytes",
            "Allocator high-water mark; a new peak also records an "
            "hbm_peak flight event with the tenant partition")
        fam = registry.gauge(
            "ome_engine_hbm_tenant_bytes",
            "Device bytes attributed per tenant: weights (quantizer "
            "byte model), kv_cache (pool/slab capacity), prefix_cache "
            "(its byte counter), workspace (the residual)",
            labelnames=("tenant",))
        self._tenants = {t: fam.labels(tenant=t) for t in HBM_TENANTS}

    @classmethod
    def for_engine(cls, engine, registry, flight=None
                   ) -> Optional["HbmAccountant"]:
        """Build an accountant for a real engine (or a wrapper that
        delegates to one); None for fakes without a config and a weight
        byte model (scheduler tests)."""
        wb = getattr(engine, "weight_bytes", None)
        if getattr(engine, "cfg", None) is None or not callable(wb):
            return None
        return cls(registry, weight_bytes=wb(),
                   device=getattr(engine, "device", None), flight=flight)

    def _read_stats(self) -> Optional[Dict[str, float]]:
        if self._stats_fn is not None:
            try:
                return self._stats_fn()
            except Exception:  # noqa: BLE001 - scrape must not fail
                return None
        dev = self._device
        if dev is None or dev.type != "cuda":
            return None
        if self._limit is None:
            self._limit = float(torch.cuda.mem_get_info(dev)[1])
        s = torch.cuda.memory_stats(dev)  # {} before the first alloc
        return {"bytes_in_use": float(s.get("reserved_bytes.all.current",
                                            0)),
                "peak_bytes_in_use": float(s.get("reserved_bytes.all.peak",
                                                 0)),
                "bytes_limit": self._limit}

    def update(self, engine=None) -> Dict[str, float]:
        """Refresh the gauges (one /metrics scrape). Returns the
        partition dict (tests assert the arithmetic on it)."""
        kv = kv_capacity_bytes(engine) if engine is not None else 0
        pc = getattr(engine, "prefix_cache", None)
        pcb = int(getattr(pc, "bytes", 0) or 0)
        stats = self._read_stats()
        tenant_sum = self.weight_bytes + kv + pcb
        if stats:
            in_use = float(stats.get("bytes_in_use", tenant_sum))
            limit = float(stats.get("bytes_limit", 0) or 0)
            peak = float(stats.get("peak_bytes_in_use", in_use))
        else:
            in_use, limit, peak = float(tenant_sum), 0.0, 0.0
        workspace = max(in_use - tenant_sum, 0.0)
        part = {"bytes_in_use": in_use, "bytes_limit": limit,
                "peak_bytes": peak, "weights": float(self.weight_bytes),
                "kv_cache": float(kv), "prefix_cache": float(pcb),
                "workspace": workspace}
        self._g_in_use.set(in_use)
        self._g_limit.set(limit)
        self._g_peak.set(peak)
        for t in HBM_TENANTS:
            self._tenants[t].set(part[t])
        if peak > self._last_peak:
            # first observation just seats the watermark; every later
            # climb is a real event worth a post-mortem breadcrumb
            if self._last_peak and self.flight is not None:
                self.flight.record(
                    "hbm_peak",
                    peak_bytes=int(peak), bytes_in_use=int(in_use),
                    bytes_limit=int(limit),
                    weights=int(self.weight_bytes), kv_cache=int(kv),
                    prefix_cache=pcb, workspace=int(workspace))
            self._last_peak = peak
        return part
