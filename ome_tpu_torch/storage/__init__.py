"""Storage layer: URIs, providers, hub client, chunk-dedup store.

Port of ome_tpu/storage/__init__.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from .base import ObjectInfo, Storage, sha256_file, verify_tree
from .hub import HubClient, HubError
from .providers import LocalStorage, S3CompatStorage, open_storage
from .uri import StorageComponents, StorageType, StorageURIError, parse_storage_uri
from .xet import ChunkStore, DedupStats, cdc_boundaries, hash64, native_available
