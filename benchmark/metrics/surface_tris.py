"""Mean live surface triangles a step of marching tets emits: the
returned mesh's tri_mask summed, read once the window has closed.  A
mesh with no tri_mask (DLMesh) gives nothing."""


def read(ctx):
    counts = [int((m['tri_mask'] > 0).sum()) for m in ctx['spans'].meshes
              if m['tri_mask'] is not None]
    return sum(counts) / len(counts) if counts else None
