"""Object metadata and condition types (port of ome_tpu/core/meta.py).

The subset of k8s.io/apimachinery the router's service discovery reads:
ObjectMeta (labels/annotations/ownerRefs/finalizers/resourceVersion) and
the `Resource` base every API object derives from. The reference's
Conditions are status types of its control plane.
"""

from __future__ import annotations

import dataclasses
import datetime
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional

from . import serde


def now() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime("%Y-%m-%dT%H:%M:%SZ")


@dataclass
class OwnerReference:
    api_version: str = ""
    kind: str = ""
    name: str = ""
    uid: str = ""
    controller: Optional[bool] = None
    block_owner_deletion: Optional[bool] = None


@dataclass
class ObjectMeta:
    name: str = ""
    namespace: str = ""
    uid: str = ""
    resource_version: str = ""
    generation: int = 0
    labels: Dict[str, str] = field(default_factory=dict)
    annotations: Dict[str, str] = field(default_factory=dict)
    owner_references: List[OwnerReference] = field(default_factory=list)
    finalizers: List[str] = field(default_factory=list)
    creation_timestamp: Optional[str] = None
    deletion_timestamp: Optional[str] = None


@dataclass
class Resource:
    """Base for all API objects. Subclasses set KIND / API_VERSION /
    NAMESPACED class vars and declare `spec` / `status` dataclass fields."""

    KIND: ClassVar[str] = ""
    API_VERSION: ClassVar[str] = "ome.io/v1"
    NAMESPACED: ClassVar[bool] = True
    PLURAL: ClassVar[str] = ""

    metadata: ObjectMeta = field(default_factory=ObjectMeta)

    @property
    def name(self) -> str:
        return self.metadata.name

    @property
    def namespace(self) -> str:
        return self.metadata.namespace

    def key(self) -> str:
        if type(self).NAMESPACED:
            return f"{self.metadata.namespace}/{self.metadata.name}"
        return self.metadata.name

    def deepcopy(self):
        return serde.deepcopy_resource(self)

    def to_dict(self) -> dict:
        d = {"apiVersion": type(self).API_VERSION, "kind": type(self).KIND}
        d.update(serde.to_dict(self))
        return d

    @classmethod
    def from_dict(cls, data: dict):
        data = dict(data)
        data.pop("apiVersion", None)
        data.pop("kind", None)
        return serde.from_dict(cls, data)


def plural_of(cls) -> str:
    return cls.PLURAL or cls.KIND.lower() + "s"
