"""`build_client` (port of ome_tpu/cmd/manager.py:90): the client the
router's --engine-selector / --decoder-selector discovery lists Services
through. The reference's manager binary (reconcilers, webhooks, leader
election) is control plane and not part of the port.
"""

from __future__ import annotations

from ..core.client import InMemoryClient


def build_client(args):
    """InMemory (no cluster named) or a real kube-apiserver client.

    The reference's client also runs informers over every kind its
    controllers watch; the router only lists Services, so the port's
    `KubeClient` watches nothing and serves the core kinds alone."""
    if args.kube_server or args.kubeconfig or args.in_cluster:
        from ..core.kubeclient import KubeClient, KubeConfig
        if args.kube_server:
            cfg = KubeConfig(server=args.kube_server)
        elif args.in_cluster:
            cfg = KubeConfig.in_cluster()
        else:
            cfg = KubeConfig.from_kubeconfig(args.kubeconfig)
        return KubeClient(cfg)
    return InMemoryClient()
