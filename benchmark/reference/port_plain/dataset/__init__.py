from .dataset import BatchIterator, Dataset  # noqa: F401
from .dataset_mesh import DatasetMesh  # noqa: F401
from .dataset_nerf import DatasetNERF  # noqa: F401
