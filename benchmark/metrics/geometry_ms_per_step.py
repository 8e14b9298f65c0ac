"""Device milliseconds a step in the kernels launched inside the
geometry's getMesh spans (DLMesh: normals, tangents, bvh.build; DMTet:
marching tets as well)."""


def read(ctx):
    us = ctx['trace']['span_device_us']['getMesh']
    return us / 1e3 / ctx['steps'] if ctx['spans'].meshes else None
