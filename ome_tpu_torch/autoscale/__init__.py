"""Closed-loop autoscaling: trace replay + SLO-aware pool scaling.

Port of ome_tpu/autoscale/ (docs/autoscaling.md), module for module:

  * ``trace``      — reqlog-derived and synthetic request traces with
                     original inter-arrival gaps, plus time-compress /
                     burst-amplify transforms;
  * ``replay``     — open-loop load generator replaying a trace
                     through the router, measuring client-side
                     TTFT/TPOT/e2e and SLO attainment;
  * ``scrape``     — Prometheus text-exposition client with windowed
                     histogram-quantile estimation between scrapes
                     (also what the fleet SLO rollup reads through);
  * ``policy``     — pure, tick-based hysteresis deciding pool sizes
                     from a pressure signal;
  * ``pool``       — live engine pool: spawn + register with the
                     router, scale down via SIGTERM drain, journal
                     resume after a kill mid-drain;
  * ``controller`` — the loop: scrape -> pressure -> policy -> act;
  * ``fleet``      — many models on one node under a weight-byte
                     budget, evicting least-recently-used pools
                     through the drain ladder.

The engines run as subprocesses (re-entered through
``ome_tpu_torch.chaos --serve-child``) on the device the caller names
(default cuda); the controller, the pools and the replay client talk
to them over HTTP only.
"""

from .policy import PolicyConfig, PoolPolicy  # noqa: F401
from .scrape import (CounterWindow, HistogramWindow,  # noqa: F401
                     SharedScraper, fetch_metrics, parse_exposition)
from .trace import (TraceRequest, amplify_bursts, compress,  # noqa: F401
                    load_reqlog, load_trace, save_trace,
                    synthetic_trace)
