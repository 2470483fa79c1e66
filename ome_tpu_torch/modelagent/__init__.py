"""Node data plane: model staging agent (port of ome_tpu/modelagent/).

Ported so far: the weight plane (`weightplane.py`, with its CLI
`python -m ome_tpu_torch.modelagent.weightplane`) and its metrics. The
model agent's download workers, node scout and reconcilers (the
reference's `gopher.py`, `scout.py`, `reconcilers.py`) need the
operator's control plane and come with it.
"""

from .metrics import METRICS, Metrics
