"""The benchmark of speaker_recognition_tpu_torch on one NVIDIA H100: see
run.py for the command, harness.py for a run, and BENCHMARK.json at the
root for its cells and metrics."""
