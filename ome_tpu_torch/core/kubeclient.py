"""Kubernetes API client for the router's service discovery (port of
ome_tpu/core/kubeclient.py, limited to what lists a core kind).

stdlib HTTP, no client SDK: typed label-selector LIST against
kube-apiserver REST paths (/api/v1 for core kinds), auth from a
kubeconfig file (token / client cert) or the in-cluster service account
(token + CA at /var/run/secrets/kubernetes.io/serviceaccount), HTTP
errors mapped onto the same NotFoundError the InMemoryClient raises.

The reference's client also creates, updates, deletes and watches every
kind of its control plane, CRDs included (`ome.io/v1`). The router only
lists Services, so this client registers the port's core kinds
(core/k8s.py) and refuses any other kind by name.
"""

from __future__ import annotations

import base64
import json
import logging
import os
import ssl
import tempfile
import urllib.error
import urllib.parse
import urllib.request
from typing import Dict, List, Optional, Type

from .errors import NotFoundError
from .meta import Resource, plural_of

log = logging.getLogger("ome.kubeclient")


def kind_registry() -> Dict[str, Type[Resource]]:
    """kind name -> dataclass, over the port's core kinds."""
    from . import k8s as _k8s
    reg: Dict[str, Type[Resource]] = {}
    for attr in vars(_k8s).values():
        if isinstance(attr, type) and issubclass(attr, Resource) \
                and attr is not Resource and attr.KIND:
            reg[attr.KIND] = attr
    return reg


class UnsupportedKindError(ValueError):
    """A kind outside the port's core kinds (a CRD such as
    InferenceService): the router's client does not serve it."""


def rest_path(cls: Type[Resource], namespace: str = "",
              name: str = "") -> str:
    """REST collection/object path for a kind."""
    api_version = cls.API_VERSION
    if "/" in api_version:
        base = f"/apis/{api_version}"
    else:
        base = f"/api/{api_version}"
    plural = plural_of(cls)
    if cls.NAMESPACED and namespace:
        path = f"{base}/namespaces/{namespace}/{plural}"
    else:
        path = f"{base}/{plural}"
    if name:
        path += f"/{name}"
    return path


class KubeConfig:
    """Connection settings: server URL + TLS + auth header."""

    def __init__(self, server: str, token: Optional[str] = None,
                 ca_file: Optional[str] = None,
                 client_cert_file: Optional[str] = None,
                 client_key_file: Optional[str] = None,
                 insecure_skip_verify: bool = False):
        self.server = server.rstrip("/")
        self.token = token
        self.ca_file = ca_file
        self.client_cert_file = client_cert_file
        self.client_key_file = client_key_file
        self.insecure_skip_verify = insecure_skip_verify

    # -- loaders -------------------------------------------------------

    @classmethod
    def in_cluster(cls) -> "KubeConfig":
        sa = "/var/run/secrets/kubernetes.io/serviceaccount"
        host = os.environ.get("KUBERNETES_SERVICE_HOST", "kubernetes.default.svc")
        port = os.environ.get("KUBERNETES_SERVICE_PORT", "443")
        with open(os.path.join(sa, "token")) as f:
            token = f.read().strip()
        return cls(server=f"https://{host}:{port}", token=token,
                   ca_file=os.path.join(sa, "ca.crt"))

    @classmethod
    def from_kubeconfig(cls, path: Optional[str] = None,
                        context: Optional[str] = None) -> "KubeConfig":
        import yaml
        path = path or os.environ.get(
            "KUBECONFIG", os.path.expanduser("~/.kube/config"))
        with open(path) as f:
            kc = yaml.safe_load(f)
        ctx_name = context or kc.get("current-context")
        ctx = next(c["context"] for c in kc.get("contexts", [])
                   if c["name"] == ctx_name)
        cluster = next(c["cluster"] for c in kc.get("clusters", [])
                       if c["name"] == ctx["cluster"])
        user = next(u["user"] for u in kc.get("users", [])
                    if u["name"] == ctx["user"])

        def inline(data_key: str, file_key: str) -> Optional[str]:
            src = cluster if data_key.startswith("certificate-authority") \
                else user
            if src.get(file_key):
                return src[file_key]
            if src.get(data_key):
                fd, p = tempfile.mkstemp(suffix=".pem")
                with os.fdopen(fd, "wb") as f:
                    f.write(base64.b64decode(src[data_key]))
                return p
            return None

        return cls(
            server=cluster["server"],
            token=user.get("token"),
            ca_file=inline("certificate-authority-data",
                           "certificate-authority"),
            client_cert_file=inline("client-certificate-data",
                                    "client-certificate"),
            client_key_file=inline("client-key-data", "client-key"),
            insecure_skip_verify=cluster.get(
                "insecure-skip-tls-verify", False))

    # -- transport -----------------------------------------------------

    def ssl_context(self) -> Optional[ssl.SSLContext]:
        if not self.server.startswith("https"):
            return None
        ctx = ssl.create_default_context(cafile=self.ca_file)
        if self.insecure_skip_verify:
            ctx.check_hostname = False
            ctx.verify_mode = ssl.CERT_NONE
        if self.client_cert_file:
            ctx.load_cert_chain(self.client_cert_file, self.client_key_file)
        return ctx

    def headers(self) -> Dict[str, str]:
        h = {"Content-Type": "application/json",
             "Accept": "application/json"}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h


class KubeClient:
    """Typed LIST over kube-apiserver with the InMemoryClient's
    signature, core kinds only."""

    def __init__(self, config: KubeConfig):
        self.config = config
        self._registry = kind_registry()
        self._ssl = config.ssl_context()

    def _kind(self, cls: Type[Resource]) -> Type[Resource]:
        if self._registry.get(getattr(cls, "KIND", "")) is not cls:
            raise UnsupportedKindError(
                f"kind {getattr(cls, 'KIND', cls)!r} "
                f"({getattr(cls, 'API_VERSION', '?')}) is not served by "
                f"the port's KubeClient: it lists the core kinds "
                f"{sorted(self._registry)} only")
        return cls

    # -- low-level HTTP ------------------------------------------------

    def _get(self, path: str, query: Optional[Dict[str, str]] = None,
             timeout: float = 30.0):
        url = self.config.server + path
        if query:
            url += "?" + urllib.parse.urlencode(query)
        req = urllib.request.Request(url, headers=self.config.headers())
        try:
            resp = urllib.request.urlopen(req, timeout=timeout,
                                          context=self._ssl)
        except urllib.error.HTTPError as e:
            detail = ""
            try:
                detail = e.read().decode("utf-8", "replace")[:500]
            except Exception:
                pass
            if e.code == 404:
                raise NotFoundError(f"GET {path}: {detail}") from e
            raise APIServerError(
                f"GET {path}: HTTP {e.code}: {detail}") from e
        with resp:
            payload = resp.read()
        return json.loads(payload) if payload else None

    # -- reads ---------------------------------------------------------

    def list(self, cls: Type[Resource], namespace: Optional[str] = None,
             label_selector: Optional[Dict[str, str]] = None,
             ) -> List[Resource]:
        cls = self._kind(cls)
        query: Dict[str, str] = {}
        if label_selector:
            query["labelSelector"] = ",".join(
                f"{k}={v}" for k, v in sorted(label_selector.items()))
        path = rest_path(cls, namespace or "")
        out = self._get(path, query=query or None)
        items = [cls.from_dict(item) for item in out.get("items", [])]
        items.sort(key=lambda o: (o.metadata.namespace, o.metadata.name))
        return items


class APIServerError(Exception):
    pass
