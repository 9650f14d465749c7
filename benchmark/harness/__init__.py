"""The benchmark's yardstick: reading the cells of `BENCHMARK.json`, the
traffic generator, the seeded weights, the trace readers, the operation
and byte counts, and the two drivers (training and serving) with the
comparisons that decide `correct`. Nothing here may be changed by a PR
that claims a gain; new cells, traffic mixes and metrics are new files.
"""
