"""The benchmark of bvsc_tpu_torch on one NVIDIA H100 (see BENCHMARK.json and PERF.md)."""
