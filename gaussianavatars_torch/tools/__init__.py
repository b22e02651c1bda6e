"""Entry points of the port: `train` and `train_synthetic` (fit an avatar),
`render` and `metrics` (replay and score a trained model directory), the
viewers (`local_viewer`, `remote_viewer`), the FPS benchmarks
(`fps_benchmark_demo`, `fps_benchmark_dataset`), and the developer tools
`stage_timings` (per-stage ms of the step), `kernel_ab` (the A/B of the
compositor kernels) and `micro_reduce_bench`."""
