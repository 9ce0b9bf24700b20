"""GPU kernels for the renderer's hot ops (Pallas, Triton route)."""
