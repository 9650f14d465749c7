"""Training (the loop, its schedule, checkpoints, metrics and parameter
surgery), evaluation (the validation protocol) and the benchmark
submission writers."""
