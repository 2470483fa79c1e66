"""HuggingFace config.json parsers (pkg/hfutil/modelconfig analog).

Port of ome_tpu/hfconfig/__init__.py: the same names, formats and behaviour;
it imports nothing of ome_tpu.
"""

from .parser import (ConfigParseError, FamilyHandler, ParsedModelConfig,
                     parse_config, parse_model_dir, supported_model_types)
