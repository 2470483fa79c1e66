"""ome.io/v1 API types (port of ome_tpu/apis/v1/).

Only the model types are ported so far: the weight plane's config
parser reads `ModelCapability` and the parameter-size helpers. The
other kinds (InferenceService, ServingRuntime, AcceleratorClass,
BenchmarkJob) come with the operator's control plane.
"""

from .model import (
    BaseModel,
    BaseModelSpec,
    ClusterBaseModel,
    DownloadPolicy,
    FineTunedWeight,
    FineTunedWeightSpec,
    ModelCapability,
    ModelFormat,
    ModelFrameworkSpec,
    ModelQuantization,
    ModelState,
    ModelStatusSpec,
    StorageSpec,
    format_parameter_size,
    parse_parameter_size,
)
