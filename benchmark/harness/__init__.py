"""Shared code of the benchmark harness."""
