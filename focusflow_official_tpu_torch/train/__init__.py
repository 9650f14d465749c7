"""Training (the loop, its schedule, checkpoints, metrics, parameter
surgery and data parallelism over processes), evaluation (the validation protocol) and the benchmark
submission writers."""
