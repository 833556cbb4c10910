"""Model configurations of the port (copies of ``repro/configs``)."""

from repro_torch.configs.base import ModelConfig  # noqa: F401
from repro_torch.configs.registry import (  # noqa: F401
    get_config,
    get_smoke_config,
)
