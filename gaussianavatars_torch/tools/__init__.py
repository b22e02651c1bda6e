"""Developer entry points of the port: `kernel_ab`, the A/B of the compositor kernels."""
