"""Entry points of the port: `train_synthetic` (fit an avatar), `render` and
`metrics` (replay and score a trained model directory), the FPS benchmarks
(`fps_benchmark_demo`, `fps_benchmark_dataset`), and the developer tools
`kernel_ab` (the A/B of the compositor kernels) and `micro_reduce_bench`."""
