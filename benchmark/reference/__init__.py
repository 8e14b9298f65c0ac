"""The plain reference: step.py, the reference's own training step
(losses, regularizers, the gradient's conventions, Adam and its
schedule, the projections), geometry.py (normals, tangents, the tet
grid, marching tets), neural.py (the hash grid and its MLP), written
from upstream nvdiffrecmc's semantics; port_plain/, a frozen copy of the
plain PyTorch renderer of nvdiffrecmc_tpu_torch at commit 33f28f5 with
every hand-written kernel's dispatch replaced by its plain twin; and
follow.py, which runs it through a cell's first steps.  Nothing here
imports the program or JAX."""
