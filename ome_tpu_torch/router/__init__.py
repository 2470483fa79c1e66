"""The port's router (port of ome_tpu/router/): OpenAI-API load balancer
and PD request router in front of the port's engine replicas.

`server.py` is the threaded data path and the policy core (Router,
Backend, PrefixDirectory, ModelMap), `aserver.py` the asyncio data
path, `gossip.py` the anti-entropy between router replicas.
`python -m ome_tpu_torch.router` runs `server.main`,
`python -m ome_tpu_torch.router.aserver` the asyncio router.
"""

from .server import RouterServer, main  # noqa: F401
