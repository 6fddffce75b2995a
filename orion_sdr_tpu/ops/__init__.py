"""Hand-written GPU kernels, each with a plain JAX reference in its home
module and a dispatch rule that picks the reference off the GPU."""
