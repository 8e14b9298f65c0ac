"""Geometry representations."""
from .dlmesh import DLMesh  # noqa: F401
