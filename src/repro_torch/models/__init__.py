"""The language-model zoo: the serving path of all ten assigned
architectures (see transformer.Model)."""
from .common import ArchConfig
from .transformer import Model

__all__ = ["ArchConfig", "Model"]
