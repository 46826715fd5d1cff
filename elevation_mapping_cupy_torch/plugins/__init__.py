"""Post-processing plugins: the manager and the ten built-in plugins."""

from .manager import PluginBase, PluginManager, PluginParams  # noqa: F401
from . import builtin  # noqa: F401
