"""The bf16 tile's tensor-core operands (csrc/packed_tile.cuh) in plain torch.

K1's and K4's mm_bf16 and K6's bf16 route run X = bf16(frame) . bf16(D) as
mma.sync m16n8k16 (bf16 operands, f32 sums) from D packed once by
ops/gpu_frontend.dft_mma_operator and the tile's samples staged as bf16.
The kernel runs on the card only (chip_smoke.py phase 21); here its
operands are walked fragment by fragment as the PTX ISA lays them out, in
the kernel's k-order and with its addressing (the ldmatrix route on rows of
fshift + 8, 16-bit loads on contiguous samples, the samples read from
device memory), and the result held to the port's plain version and to the
JAX package's bf16 K4 (pallas_frontend.packed_from_frames(mm_bf16=True) in
interpret mode) on the same numpy frames.

Tolerances: X against a float64 product of the same rounded operands within
f32 rounding, 2^-24 * (depth + 16) of sum |frame| |D| a term; the features
at test_torch_bf16's bounds (the raw autocorrelation 1e-5 of its lag 0,
the cepstra 1e-4 absolute), each cepstrum's bound widened where its mel
sums cancel to 16 ulps of sum |X^2| |W| on them, carried through the log
and the DCT (gpu_frontend.bf16_cepstra_limits, as chip_smoke.py holds the
kernel): the packed W has negative weights (a third of them at 128
filters), and there no two f32 orders of the same sums agree to 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

import jax.numpy as jnp  # noqa: E402

from speaker_recognition_tpu.ops import pallas_frontend  # noqa: E402
from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.models.gmm import round_bf16  # noqa: E402
from speaker_recognition_tpu_torch.ops import framing, gpu_frontend  # noqa: E402

KSTEP, CC = gpu_frontend.MMA_DEPTH, gpu_frontend.MMA_COLUMNS
CEPS_ATOL, CEPS_ULPS, ACORR_RTOL = 1e-4, 16, 1e-5

# (fs, FeatureConfig overrides, the tile's frames as the card's pick takes
# them, the routes of the A fragments to walk)
GEOMETRIES = {
    "bench_8k": (8000, {}, 128, ("ldmatrix", "global")),
    "odd_44k": (44100, {"mfcc": tcfg.MfccConfig(fft_size=4096)}, 32,
                ("u16", "global")),
    "144_outputs": (8000, {"mfcc": tcfg.MfccConfig(n_filters=128)}, 64,
                    ("ldmatrix",)),
}


def _frontend(fs, overrides):
    return text.PackedFrontend(fs, tcfg.FeatureConfig(**overrides), "cpu",
                               mm="bf16")


def _unpack(Dp, flen, ncols):
    """The packed operator back to [depth, width] (the inverse of
    dft_mma_operator's permutation)."""
    kp, cp = -(-flen // KSTEP) * KSTEP, -(-ncols // CC) * CC
    v = Dp.view(cp // CC, kp // 16, 4, 8, 4, 2, 2, 2)  # c ks p g t nt kb h
    return v.permute(1, 6, 4, 7, 0, 2, 5, 3).reshape(kp, cp)


def _b_tiles(Dp, flen, ncols):
    """[chunks, k-steps, 16, CC]: B of each k-step of each column chunk as
    the lanes hold it (PTX ISA, m16n8k16 .bf16: lane 4g + t holds rows 2t,
    2t+1 (its first register) and 2t+8, 2t+9 (its second) of column g of an
    n8 tile), read from the 16 bytes a lane loads: the first two registers
    for n8 tile 2p, the next two for 2p + 1."""
    KS, NC = -(-flen // KSTEP), -(-ncols // CC)
    e = Dp.view(NC, KS, CC // 16, 32, 8).float()
    B = torch.full((NC, KS, 16, CC), float("nan"))
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for nt in range(2):
            cols = torch.arange(CC // 16) * 16 + 8 * nt + g
            for r, k in enumerate((2 * t, 2 * t + 1, 2 * t + 8, 2 * t + 9)):
                B[:, :, k, cols] = e[:, :, :, lane, 4 * nt + r]
    return B


def _segment(rest, ft, flen, fshift):
    """The tile's samples as the kernel stages them: bf16, sample s at (s //
    fshift) * stride + s % fshift, zeros past the utterance; the 8-sample
    pads of the rows are NaN, so that a read of one shows."""
    kp = -(-flen // KSTEP) * KSTEP
    rows = ((ft - 1) * fshift + kp + fshift - 1) // fshift
    rs = fshift + 8 if fshift % 16 == 0 else fshift
    n = rows * fshift
    src = torch.zeros(n)
    src[:min(n, rest.shape[0])] = rest[:n]
    seg = torch.full((rows * rs,), float("nan"))
    i = torch.arange(n)
    seg[i // fshift * rs + i % fshift] = round_bf16(src)
    return seg, rs


def _a_tiles(rest, ft, flen, fshift, route):
    """[m16 tiles, k-steps, 16, 16]: A of each k-step of each m16 tile of a
    tile of ft frames whose first sample starts `rest` (the utterance from
    there on), gathered with the kernel's addressing of each route."""
    KS = -(-flen // KSTEP)
    A = torch.full((ft // 16, KS, 16, 16), float("nan"))
    if route == "global":  # each value from the f32 samples, rounded
        for mt in range(ft // 16):
            for ks in range(KS):
                si = ((16 * mt + torch.arange(16))[:, None] * fshift
                      + 16 * ks + torch.arange(16)[None, :])
                ok = si < rest.shape[0]
                A[mt, ks] = torch.where(
                    ok, round_bf16(rest[si.clamp_max(rest.shape[0] - 1)]),
                    torch.zeros(()))
        return A
    seg, rs = _segment(rest, ft, flen, fshift)
    lanes = torch.arange(32)
    for mt in range(ft // 16):
        m0 = 16 * mt
        for ks in range(KS):
            k0 = KSTEP * ks
            if route == "ldmatrix":  # lane l gives the address of one row
                assert fshift % 16 == 0
                row = (lanes & 7) + ((lanes >> 3) & 1) * 8
                col = (lanes >> 4) * 8
                addr = (m0 + row + k0 // fshift) * rs + k0 % fshift + col
                for lane in range(32):
                    a, r, c = (int(v[lane]) for v in (addr, row, col))
                    A[mt, ks, r, c:c + 8] = seg[a:a + 8]
            else:  # lane (g, t): 16-bit loads of its 8 values
                assert rs == fshift
                for lane in range(32):
                    g, t = lane // 4, lane % 4
                    r0 = (m0 + g) * fshift + k0 + 2 * t
                    for dr, dk in ((0, 0), (8, 0), (0, 8), (8, 8)):
                        at = r0 + dr * fshift + dk
                        A[mt, ks, g + dr, 2 * t + dk:2 * t + dk + 2] = \
                            seg[at:at + 2]
    return A


def _walk(signals, fe, ft, route):
    """X [B, T, ncols] of every frame, tile by tile: the MMAs of each
    column chunk summed over the k-steps in order, in f32."""
    flen, fshift = fe.frame_len, fe.frame_shift
    ncols = fe.D.shape[1]
    B = _b_tiles(gpu_frontend.dft_mma_operator(fe.D), flen, ncols)
    Bn, Lp = signals.shape
    T = (Lp - flen) // fshift + 1
    X = torch.empty(Bn, T, ncols)
    for b in range(Bn):
        for f0 in range(0, T, ft):
            A = _a_tiles(signals[b, f0 * fshift:], ft, flen, fshift, route)
            x = torch.zeros(ft // 16, B.shape[0], 16, CC)
            for ks in range(A.shape[1]):
                x = x + A[:, ks][:, None] @ B[:, ks][None]
            x = x.permute(0, 2, 1, 3).reshape(ft, -1)[:, :ncols]
            nf = min(ft, T - f0)
            X[b, f0:f0 + nf] = x[:nf]
    return X


def _wa_chunks(WAp, ncols, nout):
    """[output chunks, column chunks, CC, 8 * opl]: the W | A chunk each
    stage 2 of the kernel reads, lane og's weight j taken from its padded
    group of ogs (12 or 20) as output og + 8 j."""
    opl = 9 if nout <= 72 else 16
    ogs = 12 if opl == 9 else 20
    nch = 1 if nout <= 128 else -(-nout // 128)
    ncc = -(-ncols // CC)
    v = WAp.view(nch, ncc, CC, 8, ogs)
    assert (v[..., opl:] == 0).all()  # the pads of a lane's group
    return v[..., :opl].transpose(-1, -2).reshape(nch, ncc, CC, 8 * opl)


def _sums(X, fe):
    """Stage 2 on the walk's X: Y = X^2 onto the packed W | A, output chunk
    by output chunk, column chunk by column chunk in order (f32), then
    log(max(mel, floor)) | autocorrelation."""
    ncols, nmel = fe.W.shape
    nout = nmel + fe.A.shape[1]
    wa = _wa_chunks(gpu_frontend.dense_wa_operator(fe.W, fe.A), ncols, nout)
    Y = X * X
    Y = torch.nn.functional.pad(Y, (0, wa.shape[1] * CC - ncols))
    acc = []
    for oc in range(wa.shape[0]):
        a = 0
        for c in range(wa.shape[1]):
            a = a + Y[..., c * CC:(c + 1) * CC] @ wa[oc, c]
        acc.append(a)
    acc = torch.cat(acc, dim=-1)[..., :nout]
    return (torch.log(torch.clamp_min(acc[..., :nmel], fe.floor)),
            acc[..., nmel:])


def _signals(fs, fe, n_tiles_frames, seed):
    """Two utterances of noise, the second shorter than the padded length,
    spanning n_tiles_frames frames."""
    rng = np.random.RandomState(seed)
    Lp = (n_tiles_frames - 1) * fe.frame_shift + fe.frame_len
    sig = (rng.randn(2, Lp) * 3000).astype(np.float32)
    sig[1, Lp - 3 * fe.frame_shift:] = 0
    return torch.from_numpy(sig)


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_packed_dft_unpacks_to_the_rounded_operator(name):
    """dft_mma_operator: D rounded to bf16 (nearest even), its rows padded
    with zeros to a multiple of 16 (the MMA's depth; 1411 -> 1424 at
    44.1 kHz), its columns to a multiple of 64; the kernel's size."""
    fs, over, _, _ = GEOMETRIES[name]
    fe = _frontend(fs, over)
    flen, ncols = fe.D.shape
    Dp = gpu_frontend.dft_mma_operator(fe.D)
    assert Dp.dtype == torch.bfloat16 and Dp.dim() == 1
    full = _unpack(Dp, flen, ncols)
    kp, cp = full.shape
    assert kp % 16 == 0 and kp - flen < 16 and cp % 64 == 0
    assert torch.equal(full[:flen, :ncols].float(), round_bf16(fe.D))
    assert (full[flen:] == 0).all() and (full[:, ncols:] == 0).all()
    assert Dp.numel() == kp * cp
    # the bits of round_bf16's nearest-even rounding, not a truncation
    assert not torch.equal(round_bf16(fe.D),
                           (fe.D.view(torch.int32) & ~0xFFFF).view(
                               torch.float32))


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_fragment_walk_reproduces_the_plain_product(name):
    """The MMAs over the packed D and the staged samples, in the kernel's
    k-order, reproduce bf16(frames) . bf16(D) within f32 rounding, by every
    route of the A fragments the geometry takes (the ldmatrix route reads
    no pad of the staged rows: they are NaN here). Then Y = X^2 through
    [W | A] in chunks of 128 outputs matches the port's plain K4 and the
    JAX package's bf16 K4 in interpret mode (the tile's pre-CMVN cepstra
    and raw autocorrelation)."""
    fs, over, ft, routes = GEOMETRIES[name]
    fe = _frontend(fs, over)
    sig = _signals(fs, fe, ft + 9, seed=len(name))
    frames = framing.frame_signal(sig, fe.frame_len, fe.frame_shift)
    fb, Db = round_bf16(frames).double(), round_bf16(fe.D).double()
    exact = fb @ Db
    scale = fb.abs() @ Db.abs()
    tol = 2.0 ** -24 * (fe.frame_len + 16) * scale
    for route in routes:
        X = _walk(sig, fe, ft, route)
        assert torch.isfinite(X).all(), route
        assert ((X.double() - exact).abs() <= tol).all(), route
    logmel, r = _sums(X, fe)
    ceps = logmel @ fe.dct
    flat = frames.reshape(-1, fe.frame_len)
    pc, pr = gpu_frontend.packed_from_frames_reference(
        flat, fe.D, fe.W, fe.dct, fe.floor, fe.A, mm_bf16=True)
    jc, jr = pallas_frontend.packed_from_frames(
        jnp.asarray(flat.numpy()), fe.D.numpy(), fe.W.numpy(),
        fe.dct.numpy(), fe.floor, A=fe.A.numpy(), interpret=True,
        mm_bf16=True)
    ceps, r = ceps.reshape(pc.shape), r.reshape(pr.shape)
    jc, jr = torch.tensor(np.asarray(jc)), torch.tensor(np.asarray(jr))
    lag0 = pr[:, :1].abs()
    lim = gpu_frontend.bf16_cepstra_limits(
        flat, fe.D, fe.W, fe.dct, fe.floor, None, False, CEPS_ULPS,
        CEPS_ATOL)
    for wc, wr in ((pc, pr), (jc, jr)):
        assert ((ceps - wc).abs() <= lim).all()
        assert ((r - wr).abs() <= ACORR_RTOL * lag0).all()
    # the f32 product (nothing rounded) lies past the same limits
    f32c = gpu_frontend.packed_from_frames_reference(
        flat, fe.D, fe.W, fe.dct, fe.floor, fe.A)[0]
    assert float(((f32c - pc).abs() / lim).max()) >= 3.0


@pytest.mark.parametrize("name", sorted(GEOMETRIES))
def test_packed_wa_unpacks_to_w_and_a(name):
    """dense_wa_operator: per output chunk and column chunk of 64, a lane's
    outputs og + 8 j in a group of 12 (9 outputs a lane, up to 72) or 20
    (16, past 72; chunks of 128 outputs past 128), zeros past the columns,
    the outputs and a lane's outputs."""
    fs, over, _, _ = GEOMETRIES[name]
    fe = _frontend(fs, over)
    ncols, nmel = fe.W.shape
    nout = nmel + fe.A.shape[1]
    wa = _wa_chunks(gpu_frontend.dense_wa_operator(fe.W, fe.A), ncols, nout)
    nch, ncc = wa.shape[:2]
    full = wa.permute(1, 2, 0, 3).reshape(ncc * CC, -1)
    assert full.shape[1] == nch * (72 if nout <= 72 else 128)
    assert torch.equal(full[:ncols, :nmel], fe.W)
    assert torch.equal(full[:ncols, nmel:nout], fe.A)
    assert (full[ncols:] == 0).all() and (full[:, nout:] == 0).all()


def test_packed_dft_is_rebuilt_when_d_changes():
    """dft_mma_operator packs D once and again after D is written to; a
    copy of D is packed apart; dense_wa_operator likewise for W and A."""
    fe = _frontend(8000, {})
    D = fe.D.clone()
    first = gpu_frontend.dft_mma_operator(D)
    assert gpu_frontend.dft_mma_operator(D) is first
    D.mul_(2.0)
    second = gpu_frontend.dft_mma_operator(D)
    assert second is not first
    assert torch.equal(_unpack(second, *D.shape)[:D.shape[0], :D.shape[1]]
                       .float(), round_bf16(D))
    assert torch.equal(_unpack(first, *D.shape)[:D.shape[0], :D.shape[1]]
                       .float(), round_bf16(fe.D))
    other = D.clone()
    assert gpu_frontend.dft_mma_operator(other) is not second
    W, A = fe.W.clone(), fe.A.clone()
    wa = gpu_frontend.dense_wa_operator(W, A)
    assert gpu_frontend.dense_wa_operator(W, A) is wa
    A.add_(1.0)
    assert gpu_frontend.dense_wa_operator(W, A) is not wa


@pytest.mark.parametrize("n_filters", [50, 128])
def test_cepstra_limits_part_the_f32_product_not_two_orders(n_filters):
    """bf16_cepstra_limits through CMVN: two f32 orders of the same rounded
    products (torch's product, and the kernel's k-steps of 16 added in
    order) lie within the limits; the f32 product at least 3 limits from
    both."""
    fe = _frontend(8000, {"mfcc": tcfg.MfccConfig(n_filters=n_filters)})
    sig = torch.from_numpy((np.random.RandomState(n_filters).randn(
        3, 16000) * 3000).astype(np.float32))
    frames = framing.frame_signal(sig, fe.frame_len, fe.frame_shift)
    mask = torch.ones(frames.shape[:2], dtype=torch.bool)
    mask[2, 60:] = False
    fb, Db = round_bf16(frames), round_bf16(fe.D)
    steps = sum(fb[..., k:k + KSTEP] @ Db[k:k + KSTEP]
                for k in range(0, fe.frame_len, KSTEP))

    def cepstra(X):
        c = torch.log(torch.clamp_min((X * X) @ fe.W, fe.floor)) @ fe.dct
        return gpu_frontend.masked_cmvn(c, mask)[mask]

    plain, walk, f32 = (cepstra(X) for X in (fb @ Db, steps, frames @ fe.D))
    lim = gpu_frontend.bf16_cepstra_limits(
        frames, fe.D, fe.W, fe.dct, fe.floor, mask, True, CEPS_ULPS,
        CEPS_ATOL)[mask]
    assert ((walk - plain).abs() <= lim).all()
    for ref in (plain, walk):
        assert float(((f32 - ref).abs() / lim).max()) >= 3.0
    # every limit at 50 filters within chip_smoke.py's 2e-4; at 128 the
    # cancelling sums lift them all past 1e-4 and some past 1e-2
    if n_filters == 50:
        assert float(lim.max()) <= 2 * CEPS_ATOL
    else:
        assert (lim > CEPS_ATOL).all() and float(lim.max()) > 100 * CEPS_ATOL

