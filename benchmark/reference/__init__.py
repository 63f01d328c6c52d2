"""The plain reference and the benchmark's own inputs."""
