"""Model metadata extraction.

Re-designs internal/ome-agent/model-metadata (metadata.go): parse a
staged model directory and publish its metadata — as JSON on stdout/file
for init-container use, or written back into a (Cluster)BaseModel CR
when a client is given (same write-back path the model-agent uses).

Port of ome_tpu/agent/metadata.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Optional

from ..hfconfig import ConfigParseError, parse_model_dir


def extract_metadata(model_dir: str) -> dict:
    parsed = parse_model_dir(model_dir)
    out = dataclasses.asdict(parsed)
    out["parameter_size"] = parsed.parameter_size
    return {k: v for k, v in out.items() if v not in (None, [], {}, "")}


def publish_metadata(model_dir: str, out_file: Optional[str] = None) -> dict:
    try:
        meta = extract_metadata(model_dir)
    except ConfigParseError as e:
        meta = {"error": str(e)}
    if out_file:
        with open(out_file, "w") as f:
            json.dump(meta, f, indent=2)
    return meta
