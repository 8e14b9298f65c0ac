"""Geometry representations."""
from .dlmesh import DLMesh  # noqa: F401
from .dmtet import DMTetGeometry  # noqa: F401
