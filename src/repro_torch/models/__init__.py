"""LM substrate of the port (port of ``repro.models``): the dense, vlm,
moe, hybrid, ssm and encdec families and the serving steps around them."""
from repro_torch.models import api
from repro_torch.models.common import ArchConfig

__all__ = ["ArchConfig", "api"]
