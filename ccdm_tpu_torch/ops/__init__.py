"""Array ops and the hand-written CUDA kernels, one module per ccdm_tpu.ops
counterpart."""
