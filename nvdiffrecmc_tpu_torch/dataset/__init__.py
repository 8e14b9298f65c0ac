"""Datasets."""
from .dataset_mesh import DatasetMesh  # noqa: F401
