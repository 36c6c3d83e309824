"""Device time of the frontend's kernels a batch: the signal kernels of
ops/gpu_frontend (K1 csrc/frontend.cu and K5 from the signals
csrc/frontend_full_signals.cu on the cells' routes, with the other routes'
kernels named too) and cmvn_kernel, summed over the traced window and
divided by its batches."""

LAYER = "frontend"
UNIT = "ms"
BETTER = "lower"
MOVES = "audio_s_per_s"

KERNELS = frozenset({
    "packed_frontend_kernel", "full_signals_kernel", "lpcc_signals_kernel",
    "lpcc_kernel", "cmvn_kernel", "big_features_kernel",
    "power_project_kernel", "combine_kernel", "outputs_kernel",
    "column_kernel", "power_rows_kernel", "chirp_rows_kernel",
    "spectrum_kernel", "chirp_cluster_kernel", "chirp_frames_kernel",
    "fft_frames_kernel", "fft_packed_frames_kernel",
    "frames_frontend_kernel", "dense_bf16_kernel"})


def base_name(name: str) -> str:
    """A kernel's name without return type, namespaces (the program's
    kernels sit in an anonymous one), template arguments or parameters."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    return name.split("<")[0].split("(")[0].split("::")[-1].strip()


def read(ctx):
    us = sum(e.dur for e in ctx.trace.kernels
             if base_name(e.name) in KERNELS)
    if not us or not ctx.batches:
        return None
    return us / 1e3 / ctx.batches
