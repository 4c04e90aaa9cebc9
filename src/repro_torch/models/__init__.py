"""The language-model zoo's dense-GQA path (see transformer.Model)."""
from .common import ArchConfig
from .transformer import Model

__all__ = ["ArchConfig", "Model"]
