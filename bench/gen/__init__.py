"""Device-side generators of the benchmark's graphs and inputs."""
