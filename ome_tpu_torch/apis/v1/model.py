"""BaseModel / ClusterBaseModel / FineTunedWeight types.

Mirrors pkg/apis/ome/v1beta1/model.go: model format,
framework, architecture, quantization, parameter size, capabilities,
storage spec with node placement constraints, lifecycle status.

Port of ome_tpu/apis/v1/model.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import ClassVar, Dict, List, Optional

from ...core.meta import Resource


class ModelQuantization(str, enum.Enum):
    """model.go:262-268, plus int8."""

    FP8 = "fp8"
    FBGEMM_FP8 = "fbgemm_fp8"
    INT4 = "int4"
    INT8 = "int8"


class DownloadPolicy(str, enum.Enum):
    """model.go:150-156."""

    ALWAYS = "AlwaysDownload"
    REUSE = "ReuseIfExists"


class ModelCapability(str, enum.Enum):
    TEXT_GENERATION = "TEXT_GENERATION"
    TEXT_EMBEDDINGS = "TEXT_EMBEDDINGS"
    TEXT_RERANK = "TEXT_RERANK"
    VISION = "VISION"
    CHAT = "CHAT"
    IMAGE_GENERATION = "IMAGE_GENERATION"


@dataclass
class ModelFormat:
    """Weight format (safetensors, ...) with optional version (model.go)."""

    name: str = ""
    version: Optional[str] = None
    # weight for runtime scoring; operand of the scorer's
    # format-weight x priority product (runtimeselector/scorer.go:104-164)
    weight: Optional[int] = None


@dataclass
class ModelFrameworkSpec:
    name: str = ""  # transformers | maxtext | jax | ...
    version: Optional[str] = None
    weight: Optional[int] = None


@dataclass
class StorageSpec:
    """model.go:102-148 — where weights live and which nodes stage them."""

    storage_uri: Optional[str] = None  # hf:// gcs:// s3:// oci:// pvc:// local:// ...
    path: Optional[str] = None  # node-local target path
    schema_path: Optional[str] = None
    parameters: Dict[str, str] = field(default_factory=dict)
    storage_key: Optional[str] = None  # secret key for auth
    node_selector: Dict[str, str] = field(default_factory=dict)
    node_affinity: Optional[dict] = None
    download_policy: Optional[DownloadPolicy] = None


@dataclass
class BaseModelSpec:
    """model.go:159-228."""

    model_format: ModelFormat = field(default_factory=ModelFormat)
    model_framework: Optional[ModelFrameworkSpec] = None
    model_architecture: Optional[str] = None  # e.g. LlamaForCausalLM
    quantization: Optional[ModelQuantization] = None
    model_parameter_size: Optional[str] = None  # e.g. "8.03B"
    model_capabilities: List[str] = field(default_factory=list)
    model_configuration: Optional[str] = None  # raw config.json written back
    storage: Optional[StorageSpec] = None
    max_tokens: Optional[int] = None  # context length
    additional_metadata: Dict[str, str] = field(default_factory=dict)
    vendor: Optional[str] = None
    disabled: Optional[bool] = None
    version: Optional[str] = None
    display_name: Optional[str] = None
    # diffusion pipeline metadata (model.go:223-228)
    model_type: Optional[str] = None
    pipeline_class: Optional[str] = None


class ModelState(str, enum.Enum):
    CREATING = "Creating"
    IN_TRANSIT = "In_Transit"
    READY = "Ready"
    FAILED = "Failed"


@dataclass
class ModelStatusSpec:
    """Aggregated per-node staging state (model.go + basemodel controller)."""

    lifecycle: Optional[str] = None
    state: Optional[ModelState] = None
    nodes_ready: List[str] = field(default_factory=list)
    nodes_failed: List[str] = field(default_factory=list)


@dataclass
class BaseModel(Resource):
    KIND: ClassVar[str] = "BaseModel"
    spec: BaseModelSpec = field(default_factory=BaseModelSpec)
    status: ModelStatusSpec = field(default_factory=ModelStatusSpec)


@dataclass
class ClusterBaseModel(Resource):
    KIND: ClassVar[str] = "ClusterBaseModel"
    NAMESPACED: ClassVar[bool] = False
    spec: BaseModelSpec = field(default_factory=BaseModelSpec)
    status: ModelStatusSpec = field(default_factory=ModelStatusSpec)


@dataclass
class FineTunedWeightSpec:
    """model.go:423-505 — adapter weights referencing a base model."""

    base_model_ref: Optional[dict] = None  # {"name":..., "namespace":...}
    model_type: Optional[str] = None  # e.g. "LoRA"
    hyper_parameters: Optional[dict] = None
    configuration: Optional[dict] = None
    storage: Optional[StorageSpec] = None


@dataclass
class FineTunedWeight(Resource):
    KIND: ClassVar[str] = "FineTunedWeight"
    NAMESPACED: ClassVar[bool] = False
    spec: FineTunedWeightSpec = field(default_factory=FineTunedWeightSpec)
    status: ModelStatusSpec = field(default_factory=ModelStatusSpec)


def parse_parameter_size(s: Optional[str]) -> Optional[float]:
    """'8.03B' / '670B' / '500M' -> parameter count (float).

    Replaces the reference's parameter-size parsing used by the runtime
    matcher's ModelSizeRange check (runtimeselector/matcher.go).
    """
    if not s:
        return None
    s = s.strip().upper()
    for suffix in ("PARAMS", "PARAM"):
        if s.endswith(suffix):
            s = s[: -len(suffix)].strip()
    mult = 1.0
    if s.endswith("T"):
        mult, s = 1e12, s[:-1]
    elif s.endswith("B"):
        mult, s = 1e9, s[:-1]
    elif s.endswith("M"):
        mult, s = 1e6, s[:-1]
    elif s.endswith("K"):
        mult, s = 1e3, s[:-1]
    try:
        return float(s) * mult
    except ValueError:
        return None


def format_parameter_size(n: float) -> str:
    for mult, suffix in ((1e12, "T"), (1e9, "B"), (1e6, "M"), (1e3, "K")):
        if n >= mult:
            v = n / mult
            return (f"{v:.2f}").rstrip("0").rstrip(".") + suffix
    return str(int(n))
