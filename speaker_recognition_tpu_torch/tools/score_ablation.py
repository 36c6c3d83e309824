"""What padding the feature dimension to 4 rather than 8 buys the scoring
kernels, on the card.

    python -m speaker_recognition_tpu_torch.tools.score_ablation

Builds csrc/gmm_score.cu (K2, batched) and csrc/gmm_serial.cu (K3, one
utterance) twice, with the component rows padded to a multiple of 4 floats
(the tree's DSTEP) and of 8 (-DSRT_DSTEP=8: half the register-frame
instantiations, d = 28 computed as 32), and times both at the bench shapes
in turns: K2 on 512 utterances of 311 valid frames against a 4 x 32 bank and
on 8 against an 80 x 256 bank, K3 on one such utterance against 5 x 32, all
at d = 28, and K2 at d = 102 (padded to 104 either way). Each variant's
scores are held to the plain version first. Needs one CUDA card and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import tempfile
import time

import numpy as np
import torch

from .. import _build
from ..models.gmm import GmmBank, batch_bank_avg_loglik
from ..ops import gpu_gmm

VARIANTS = {"dstep4": 4, "dstep8": 8}
SOURCES = ("gmm_score.cu", "gmm_serial.cu")


def build(tmp: str) -> dict:
    """One library per variant, all nvcc processes at once; prints each
    build's seconds."""
    nvcc = _build._nvcc()
    t0 = time.perf_counter()
    procs = {name: subprocess.Popen(
        [nvcc, *_build.NVCC_FLAGS[:-2], f"-DSRT_DSTEP={step}", "-shared",
         "-o", os.path.join(tmp, name + ".so"),
         *(os.path.join(_build.CSRC, f) for f in SOURCES)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for name, step in VARIANTS.items()}
    libs = {}
    pending = dict(procs)
    while pending:  # report each build as it ends
        for name, proc in list(pending.items()):
            if proc.poll() is None:
                continue
            out = proc.communicate()[0]
            if proc.returncode:
                raise SystemExit(f"{name}: nvcc failed\n{out[-3000:]}")
            print(f"score_ablation: {name} built in "
                  f"{time.perf_counter() - t0:.1f} s (both started together)",
                  flush=True)
            del pending[name]
        time.sleep(0.2)
    p_, i_ = ctypes.c_void_p, ctypes.c_int
    for name in procs:
        lib = ctypes.CDLL(os.path.join(tmp, name + ".so"))
        lib.srt_bank_avg_loglik.argtypes = [p_] * 5 + [i_] * 5 + [p_]
        lib.srt_bank_scratch_floats.argtypes = [i_] * 4
        lib.srt_bank_scratch_floats.restype = ctypes.c_longlong
        lib.srt_bank_sum_loglik.argtypes = [p_] * 5 + [i_] * 5 + [p_]
        lib.srt_component_row.argtypes = [i_]
        lib.srt_serial_chunks.argtypes = [i_]
        libs[name] = lib
    return libs


def time_ms(fn, trials=9, reps=5) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(trials):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def random_bank(rng, S, K, d, dev) -> GmmBank:
    return GmmBank.from_numpy(
        rng.dirichlet(np.ones(K), size=S).astype(np.float32),
        rng.randn(S, K, d).astype(np.float32),
        (0.5 + rng.rand(S, K, d)).astype(np.float32), dev)


def main():
    if not torch.cuda.is_available():
        raise SystemExit("score_ablation needs a CUDA card")
    dev = torch.device("cuda", 0)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    rng = np.random.RandomState(0)
    stream = torch.cuda.current_stream(dev).cuda_stream
    T, valid = 318, 311

    def batch(B, d):
        feats = torch.from_numpy(rng.randn(B, T, d).astype(np.float32)).to(dev)
        mask = torch.zeros(B, T, dtype=torch.bool, device=dev)
        mask[:, :valid] = True
        return feats, mask

    # name -> (bank, feats, mask)
    cases = {
        "K2 512 x 311, 4 x 32, d 28": (random_bank(rng, 4, 32, 28, dev),
                                       *batch(512, 28)),
        "K2 8 x 311, 80 x 256, d 28": (random_bank(rng, 80, 256, 28, dev),
                                       *batch(8, 28)),
        "K2 64 x 311, 4 x 32, d 102": (random_bank(rng, 4, 32, 102, dev),
                                       *batch(64, 102)),
    }
    serial_bank = random_bank(rng, 5, 32, 28, dev)
    x = torch.from_numpy(rng.randn(512, 28).astype(np.float32)).to(dev)
    xm = torch.zeros(512, dtype=torch.bool, device=dev)
    xm[:valid] = True

    def packed(lib, bank):
        # not GmmBank.component_operator: it caches one layout per bank
        row = lib.srt_component_row(bank.dim)
        d, dp = bank.dim, (row - 4) // 2
        comp = bank.op.new_zeros((bank.n_speakers * bank.n_mixtures, row))
        comp[:, :d] = bank.op[:d].T
        comp[:, dp:dp + d] = bank.op[d:].T
        comp[:, 2 * dp] = bank.cw
        return comp

    with tempfile.TemporaryDirectory(dir=_build.BUILD_DIR) as tmp:
        libs = build(tmp)
        calls = {}
        for vname, lib in libs.items():
            for cname, (bank, feats, mask) in cases.items():
                B, _, d = feats.shape
                S, K = bank.n_speakers, bank.n_mixtures
                comp = packed(lib, bank)
                scratch = torch.empty(
                    lib.srt_bank_scratch_floats(B, T, d, S), device=dev)
                out = torch.empty(B, S, device=dev)

                def call(lib=lib, feats=feats, mask=mask, comp=comp,
                         scratch=scratch, out=out, B=B, d=d, S=S, K=K):
                    err = lib.srt_bank_avg_loglik(
                        feats.data_ptr(), mask.data_ptr(), comp.data_ptr(),
                        scratch.data_ptr(), out.data_ptr(), B, T, d, S, K,
                        stream)
                    assert err == 0, err
                    return out
                want = batch_bank_avg_loglik(bank, feats, mask)
                rel = ((call() - want).abs() / want.abs()).max().item()
                print(f"score_ablation: {vname} {cname}: max rel vs plain "
                      f"{rel:.3e}", flush=True)
                if not rel < 1e-4:
                    raise SystemExit(f"{vname} {cname} disagrees with plain")
                calls[vname, cname] = call
            comp3 = packed(lib, serial_bank)
            part = torch.empty(5, lib.srt_serial_chunks(512), 2, device=dev)
            out3 = torch.empty(5, device=dev)

            def call3(lib=lib, comp3=comp3, part=part, out3=out3):
                err = lib.srt_bank_sum_loglik(
                    x.data_ptr(), xm.data_ptr(), comp3.data_ptr(),
                    part.data_ptr(), out3.data_ptr(), 512, 28, 5, 32, 1,
                    stream)
                assert err == 0, err
                return out3
            want3 = gpu_gmm.bank_avg_loglik_reference(serial_bank, x, xm)
            rel = ((call3() - want3).abs() / want3.abs()).max().item()
            if not rel < 1e-4:
                raise SystemExit(f"{vname} K3 disagrees with plain: {rel}")
            calls[vname, "K3 311 of 512, 5 x 32, d 28"] = call3
        print(f"score_ablation [{card}]: median of 9 trials of 5 calls, ms",
              flush=True)
        for rnd in range(3):
            for (vname, cname), call in calls.items():
                print(f"round {rnd} {vname} {cname}: {time_ms(call):.4f}",
                      flush=True)


if __name__ == "__main__":
    main()
