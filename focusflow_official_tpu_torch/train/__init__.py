"""Evaluation: the validation protocol and the benchmark submission
writers."""
