"""LM substrate of the port (port of ``repro.models``): the dense decoder
family and the serving steps around it."""
from repro_torch.models import api
from repro_torch.models.common import ArchConfig

__all__ = ["ArchConfig", "api"]
