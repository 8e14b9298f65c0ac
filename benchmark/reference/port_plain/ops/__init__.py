"""Compute ops of the port: shading normals, transforms, textures,
rasterizer, BVH and any-hit tracer, Monte-Carlo shading, denoiser."""
