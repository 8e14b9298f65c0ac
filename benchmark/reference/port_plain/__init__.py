"""A frozen copy of the plain PyTorch code of nvdiffrecmc_tpu_torch, from
commit 33f28f5: the plain twins of the program's kernels and the
renderer around them (ops, render), the datasets, the configuration's
defaults.  The reference's own step (reference/step.py) drives it; the
training step, the losses, the optimizer, the geometry and the neural
material are not taken from here.

What changed from the source:
- every wrapper that launched a CUDA kernel of csrc/ (resolve, the sample
  guide, sample, trace + shade, shade_bwd, light_scatter, the scatter, the
  denoiser, trace, mask) runs its plain PyTorch version on every device;
  the launch code, `kernels` and `walk_args` are gone;
- ops/tracer.py: any_hit descends supernode -> leaf -> sub-box before the
  triangle tests (the same bits as the source's any_hit, kept as
  any_hit_flat); ops/pallas_raster.py: resolve_plain takes each pixel's
  least (z, id) over the (pixel, triangle) pairs of the triangles'
  rectangles (covered_pairs) instead of every pixel against every
  triangle (the same answer as resolve_batch_plain, which stays);
  ops/pallas_shade.py: the fused pipeline's sample, trace + shade and
  shade backward run PIXEL_BLOCK pixels at a time (every pixel's work is
  its own; the light gradient is the sum of the blocks').  So the plain
  step runs at the cells' sizes in the card's memory and in minutes;
- dataset: no LLFF; render/texture.py reads PNG only (no JPEG decoder);
  no ops/cubemap.py, which the step does not import;
- dataset_mesh.SPOT256_DIR points at the repository's docs/quality_r5;
- left out: train.py, geometry/, render/regularizer.py, ops/loss.py,
  ops/hashgrid.py, ops/bsdf.py (the reference writes its own step,
  losses, geometry and neural material), and every writer (OBJ, MTL,
  PNG, HDR) and helper the renderer and the datasets do not call."""
