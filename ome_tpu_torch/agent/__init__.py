"""ome-agent: model lifecycle tooling (internal/ome-agent analog).

Subsystems: enigma (encrypted model distribution), replica (cross-store
replication), serving-agent (fine-tuned-adapter sidecar),
model-metadata (config extraction). CLI: `python -m ome_tpu_torch.agent`.

Re-exports resolve lazily so each subcommand only imports what it needs
(e.g. model-metadata in a minimal init-container never pulls in
enigma's `cryptography` dependency).

Port of ome_tpu/agent/__init__.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

_EXPORTS = {
    "EnigmaError": "enigma", "KMSProvider": "enigma", "LocalKMS": "enigma",
    "decrypt_dir": "enigma", "decrypt_file": "enigma",
    "encrypt_dir": "enigma", "encrypt_file": "enigma",
    "extract_metadata": "metadata", "publish_metadata": "metadata",
    "ReplicationResult": "replica", "Replicator": "replica",
    "AdapterInfo": "serving_agent", "ServingAgent": "serving_agent",
}

__all__ = list(_EXPORTS)


def __getattr__(name):
    mod = _EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib
    return getattr(importlib.import_module(f".{mod}", __name__), name)
