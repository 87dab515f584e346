"""The port's benchmark: cells of tfkaldi_tpu_torch on the H100, found by name from BENCHMARK.json (see README.md)."""
