"""Kubernetes built-in types the router lists (port of the Service part
of ome_tpu/core/k8s.py).

Service discovery (`router/server.py::discover_backends`) turns the
Services matching a component selector into backends at their cluster
DNS names; these dataclasses model the fields it reads, with the
reference's names and JSON keys. The reference's other kinds
(Deployment, LeaderWorkerSet, ...) are what its control plane stamps
out and are not part of the port.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, ClassVar, Dict, List, Optional

from .meta import Resource


@dataclass
class ServicePort:
    name: Optional[str] = None
    port: int = 0
    target_port: Any = None
    protocol: Optional[str] = None


@dataclass
class ServiceSpec:
    selector: Dict[str, str] = field(default_factory=dict)
    ports: List[ServicePort] = field(default_factory=list)
    cluster_ip: Optional[str] = None
    type: Optional[str] = None


@dataclass
class Service(Resource):
    KIND: ClassVar[str] = "Service"
    API_VERSION: ClassVar[str] = "v1"
    spec: ServiceSpec = field(default_factory=ServiceSpec)
    status: dict = field(default_factory=dict)
