"""Device math of the decode hot loops: the plain XLA forms (the CPU
path and the references) and the GPU kernels (Pallas, Triton route)
that runtime/backend.py selects on the GPU."""
