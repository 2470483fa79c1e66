"""In-memory API store + client (port of ome_tpu/core/client.py).

The router's default discovery client when no kube-apiserver is named
(`cmd/manager.py::build_client`), and the tests' store of Services: typed
CRUD, label-selector lists, watch streams, resourceVersion conflicts,
finalizers and owner-reference garbage collection, as the reference's.
"""

from __future__ import annotations

import threading
import uuid
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Tuple, Type

from .errors import ConflictError, AlreadyExistsError, NotFoundError
from .meta import Resource, now


@dataclass
class Event:
    type: str  # Added | Modified | Deleted
    obj: Resource


class InMemoryClient:
    """Thread-safe typed object store with watch support."""

    def __init__(self, initial: Iterable[Resource] = ()):  # noqa: D401
        self._lock = threading.RLock()
        self._store: Dict[Tuple[str, str, str], Resource] = {}
        self._rv = 0
        self._watchers: List[Callable[[Event], None]] = []
        self._recorded_events: List[dict] = []  # EventRecorder sink
        for obj in initial:
            self.create(obj.deepcopy())

    # -- helpers -------------------------------------------------------

    def _key(self, cls: Type[Resource], namespace: str, name: str):
        return (cls.KIND, namespace if cls.NAMESPACED else "", name)

    def _next_rv(self) -> str:
        self._rv += 1
        return str(self._rv)

    def _notify(self, ev: Event):
        for w in list(self._watchers):
            w(ev)

    # -- CRUD ----------------------------------------------------------

    def create(self, obj: Resource) -> Resource:
        with self._lock:
            k = self._key(type(obj), obj.metadata.namespace, obj.metadata.name)
            if k in self._store:
                raise AlreadyExistsError(f"{type(obj).KIND} {obj.key()} already exists")
            obj = obj.deepcopy()
            obj.metadata.uid = obj.metadata.uid or str(uuid.uuid4())
            obj.metadata.resource_version = self._next_rv()
            obj.metadata.creation_timestamp = obj.metadata.creation_timestamp or now()
            obj.metadata.generation = 1
            self._store[k] = obj
            self._notify(Event("Added", obj.deepcopy()))
            return obj.deepcopy()

    def get(self, cls: Type[Resource], name: str, namespace: str = "") -> Resource:
        with self._lock:
            k = self._key(cls, namespace, name)
            if k not in self._store:
                raise NotFoundError(f"{cls.KIND} {namespace}/{name} not found")
            return self._store[k].deepcopy()

    def try_get(self, cls: Type[Resource], name: str, namespace: str = "") -> Optional[Resource]:
        try:
            return self.get(cls, name, namespace)
        except NotFoundError:
            return None

    def list(self, cls: Type[Resource], namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None) -> List[Resource]:
        with self._lock:
            out = []
            for (kind, ns, _), obj in self._store.items():
                if kind != cls.KIND:
                    continue
                if namespace is not None and cls.NAMESPACED and ns != namespace:
                    continue
                if label_selector and any(
                        obj.metadata.labels.get(k) != v for k, v in label_selector.items()):
                    continue
                out.append(obj.deepcopy())
            out.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
            return out

    def update(self, obj: Resource, bump_generation: bool = True) -> Resource:
        with self._lock:
            k = self._key(type(obj), obj.metadata.namespace, obj.metadata.name)
            cur = self._store.get(k)
            if cur is None:
                raise NotFoundError(f"{type(obj).KIND} {obj.key()} not found")
            if (obj.metadata.resource_version
                    and obj.metadata.resource_version != cur.metadata.resource_version):
                raise ConflictError(
                    f"{type(obj).KIND} {obj.key()}: resourceVersion conflict "
                    f"({obj.metadata.resource_version} != {cur.metadata.resource_version})")
            obj = obj.deepcopy()
            obj.metadata.uid = cur.metadata.uid
            obj.metadata.creation_timestamp = cur.metadata.creation_timestamp
            obj.metadata.resource_version = self._next_rv()
            if bump_generation:
                obj.metadata.generation = cur.metadata.generation + 1
            else:
                obj.metadata.generation = cur.metadata.generation
            self._store[k] = obj
            self._notify(Event("Modified", obj.deepcopy()))
            # finalizer-aware delete completion
            if obj.metadata.deletion_timestamp and not obj.metadata.finalizers:
                self._finish_delete(k, obj)
            return obj.deepcopy()

    def update_status(self, obj: Resource) -> Resource:
        """Status().Update() equivalent — does not bump generation."""
        return self.update(obj, bump_generation=False)

    def delete(self, obj_or_cls, name: str = None, namespace: str = "") -> None:
        with self._lock:
            if isinstance(obj_or_cls, Resource):
                cls, name, namespace = type(obj_or_cls), obj_or_cls.metadata.name, obj_or_cls.metadata.namespace
            else:
                cls = obj_or_cls
            k = self._key(cls, namespace, name)
            cur = self._store.get(k)
            if cur is None:
                raise NotFoundError(f"{cls.KIND} {namespace}/{name} not found")
            if cur.metadata.finalizers:
                if not cur.metadata.deletion_timestamp:
                    cur.metadata.deletion_timestamp = now()
                    cur.metadata.resource_version = self._next_rv()
                    self._notify(Event("Modified", cur.deepcopy()))
                return
            self._finish_delete(k, cur)

    def _finish_delete(self, k, cur: Resource):
        self._store.pop(k, None)
        self._notify(Event("Deleted", cur.deepcopy()))
        self._garbage_collect(cur)

    def _garbage_collect(self, owner: Resource):
        """k8s-style GC: drop the dead owner's references; an object is
        cascade-deleted only once its last owner reference is gone."""
        doomed = []
        for key, obj in list(self._store.items()):
            refs = obj.metadata.owner_references
            remaining = [r for r in refs if r.uid != owner.metadata.uid]
            if len(remaining) == len(refs):
                continue
            if remaining:
                obj.metadata.owner_references = remaining
                obj.metadata.resource_version = self._next_rv()
                self._notify(Event("Modified", obj.deepcopy()))
            else:
                doomed.append((key, obj))
        for key, obj in doomed:
            obj.metadata.finalizers = []
            self._finish_delete(key, obj)

    # -- watch ---------------------------------------------------------

    def watch(self, handler: Callable[[Event], None]) -> Callable[[], None]:
        with self._lock:
            self._watchers.append(handler)
            def cancel():
                with self._lock:
                    if handler in self._watchers:
                        self._watchers.remove(handler)
            return cancel

    # -- event recorder (corev1 Events) --------------------------------

    def record_event(self, obj: Resource, event_type: str, reason: str, message: str):
        with self._lock:
            self._recorded_events.append({
                "involvedObject": f"{type(obj).KIND}/{obj.key()}",
                "type": event_type, "reason": reason, "message": message,
                "timestamp": now(),
            })

    @property
    def events(self) -> List[dict]:
        with self._lock:
            return list(self._recorded_events)

