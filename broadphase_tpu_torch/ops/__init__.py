"""The port's kernels: one module per CUDA kernel, each with its plain
PyTorch version, a launch counter and a device dispatch (CPU tensor ->
plain version, CUDA tensor -> kernel or an error)."""
