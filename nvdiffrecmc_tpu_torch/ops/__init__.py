"""Compute ops of the port: transforms, textures, rasterizer, BVH and
any-hit tracer, Monte-Carlo shading, denoiser."""
