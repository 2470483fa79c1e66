"""The part of ome_tpu/autoscale/ the router reaches: `scrape`, the
Prometheus text-exposition client the fleet SLO rollup reads every
backend's /metrics through (`SharedScraper`). The autoscale controller,
its policy, pool and trace replay are control plane and not part of
the port.
"""

from .scrape import (CounterWindow, HistogramWindow,  # noqa: F401
                     SharedScraper, fetch_metrics, parse_exposition)
