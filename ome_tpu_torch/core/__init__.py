"""The API-object layer the router's service discovery needs (port of
the part of ome_tpu/core/ it reaches): `meta`/`serde` (objects and their
JSON), `k8s` (Service), `client` (InMemoryClient) and `kubeclient`
(KubeClient over a kube-apiserver, core kinds only)."""
