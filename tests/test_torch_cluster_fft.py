"""The cluster FFT of csrc/rfft_cluster.cuh modelled in float64 numpy: the
four-step route's spectrum of N = 32768 .. 262144 points (one block, or a
thread-block cluster of 2, 4 or 8 blocks, each holding 16384 complex
values in shared memory) and K5's chirp-z route past M = 8192 (M = 16384
.. 131072 on the same blocks). The model follows the kernels' data flow
index by index: the shared-memory slots of (rank, index) before and after
the exchange across the cluster, the radix-8/4 Stockham passes in place
(a pass loads every slot into registers, then stores every slot), the
pruned first pass (inputs past the frame's samples never loaded), the
twiddles from the two-level table of W_M, the exchange's C-point DFTs
and the real-input post-step. It is held to numpy.fft and to the port's
plain versions; the CUDA sources themselves run on the card
(chip_smoke.py phases 15 and 16) and, built with g++ against a stand-in
runtime, on the CPU (tests/test_torch_cuda_standin.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu_torch import config as tcfg  # noqa: E402
from speaker_recognition_tpu_torch.features import extract as text  # noqa: E402
from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402

# csrc/rfft_cluster.cuh: points a block, its threads, the largest cluster
P_BLOCK, NTH, MAX_RANKS = 16384, 512, 8


def slot(i):
    """The shared-memory slot of index i: one float2 of padding after every
    16, so that a pass's strided stores fall in distinct banks."""
    return i + (i >> 4)


def radices(p):
    """The Stockham passes of a p-point block FFT: radix 8, then one pass of
    4 or 2 for what is left."""
    lp = p.bit_length() - 1
    return [8] * (lp // 3) + ([1 << lp % 3] if lp % 3 else [])


class Twiddles:
    """W_M^m = hi[m >> lgb] lo[m & (2^lgb - 1)], each table entry from an
    exact angle (sincospif in the kernel): lgb = ceil(lg M / 2)."""

    def __init__(self, M):
        lg = M.bit_length() - 1
        self.lgb, self.M = (lg + 1) // 2, M
        self.lo = np.exp(-2j * np.pi * np.arange(1 << self.lgb) / M)
        self.hi = np.exp(-2j * np.pi * np.arange(M >> self.lgb)
                         * (1 << self.lgb) / M)

    def __call__(self, m):
        m = np.asarray(m)
        assert (m >= 0).all() and (m < self.M).all()
        return self.hi[m >> self.lgb] * self.lo[m & ((1 << self.lgb) - 1)]


def dft_regs(v):
    """DFT_R over the last axis as the kernel's registers compute it: radix-2
    decimation in frequency with the constant twiddles W_R^r, the outputs
    left in bit-reversed order and read back through it."""
    v = np.array(v, dtype=np.complex128)
    R = v.shape[-1]
    span = R // 2
    while span >= 1:
        for g in range(0, R, 2 * span):
            for r in range(span):
                a, b = v[..., g + r].copy(), v[..., g + r + span].copy()
                w = np.exp(-2j * np.pi * r / (2 * span))
                v[..., g + r], v[..., g + r + span] = a + b, (a - b) * w
        span //= 2
    lg = R.bit_length() - 1
    order = [int(format(q, f"0{lg}b")[::-1], 2) if lg else 0
             for q in range(R)]
    return v[..., order]


def block_fft(buf, load, E, C, tw, first=True):
    """The block's P-point FFT in place in buf (P + P/16 slots): each pass
    loads every slot j + r P/R of its butterflies j (the first from
    `load`, inputs at or past E never loaded: a butterfly whose inputs
    all lie past E stores zeros, one with only its first input stores that
    value R times), multiplies by W_{Ns R}^{(j mod Ns) r} = W_M^{C (j mod
    Ns) r P / (Ns R)}, takes DFT_R and stores at (j / Ns) Ns R + j mod Ns
    + q Ns. Natural order in and out."""
    P = (len(buf) * 16) // 17
    Ns = 1
    for pi, R in enumerate(radices(P)):
        S = P // R
        j = np.arange(S)
        idx = j[:, None] + S * np.arange(R)[None, :]
        if pi == 0 and first:
            v = np.zeros((S, R), np.complex128)
            live = idx < E
            v[live] = load(idx[live])
            nz = live.sum(axis=1)
            out = dft_regs(v)
            out[nz == 1] = v[nz == 1, :1]  # the broadcast
            assert not out[nz == 0].any()
        else:
            k = j & (Ns - 1)
            e = k[:, None] * np.arange(R)[None, :] * (P // (Ns * R))
            v = buf[slot(idx)] * tw(C * e)
            out = dft_regs(v)
        base = (j // Ns) * Ns * R + (j & (Ns - 1))
        dst = base[:, None] + Ns * np.arange(R)[None, :]
        assert len(np.unique(dst)) == P
        buf[slot(dst)] = out
        Ns *= R
    return buf


def blocks(C, P):
    return [np.full(P + P // 16, np.nan, np.complex128) for _ in range(C)]


def frame_z(x, N):
    """z[j] = x[2j] + i x[2j + 1] of a frame folded onto N samples, and J:
    the z past which every value is zero (the pruned stage's bound)."""
    L = min(len(x), N)
    xf = np.zeros(N)
    xf[:L] = x[:L]
    for t in range(N, len(x), N):
        xf[:min(N, len(x) - t)] += x[t:t + N]
    return xf[0::2] + 1j * xf[1::2], (L + 1) // 2


def cluster_columns(z, J, C, P, tw):
    """Ranks c < C after the block FFT of z[C p + c] (p < P, the first pass
    pruned at E_c = ceil((J - c) / C)): column(k1) = the C-point DFT over c
    of rank c's slot k1 times W_M^(c k1), i.e. X[k1 + P k2], k2 < C."""
    smem = blocks(C, P)
    for c in range(C):
        E = max(0, -(-(J - c) // C))

        def load(p, c=c, E=E):
            assert (p < E).all()
            return z[C * p + c]
        block_fft(smem[c], load, E, C, tw)
    ranks = np.arange(C)

    def column(k1):
        t = np.array([smem[c][slot(k1)] for c in ranks]) * tw(ranks * k1)
        return dft_regs(t)
    return column


def spectrum_power(x, N, P=P_BLOCK, floor=None):
    """The four-step route's power row [N/2 + 1] of one frame on a cluster
    of C = N / 2P blocks: block c loads z[C p + c] (p < P) and takes its
    P-point FFT; after the cluster's barrier a unit u in [0, P/2] reads
    slots u and P - u of every rank, multiplies by W_H^(c k1), takes the
    two C-point DFTs (X[k1 + P k2]) and the post-step power of their 2C
    bins (u = 0: bins P k2 and H; u = P/2: bins P/2 + P k2)."""
    H = N // 2
    C = H // P
    assert C * P == H and 1 <= C <= MAX_RANKS
    z, J = frame_z(x, N)
    column = cluster_columns(z, J, C, P, Twiddles(H))
    power = np.full(H + 1, np.nan)
    wN = np.exp(-1j * np.pi * np.arange(H + 1) / H)  # W_N^k, sincospif

    def post(k, a, b):
        e = 0.5 * (a + np.conj(b))
        o = -0.5j * (a - np.conj(b))
        X = e + wN[k] * o
        return abs(X) ** 2

    for u in range(P // 2 + 1):
        if u == 0:
            X = column(0)
            Z0 = X[0]
            power[0] = (Z0.real + Z0.imag) ** 2
            power[H] = (Z0.real - Z0.imag) ** 2
            for k2 in range(1, C):
                power[P * k2] = post(P * k2, X[k2], X[C - k2])
        elif u == P // 2:
            X = column(u)
            for k2 in range(C):
                power[u + P * k2] = post(u + P * k2, X[k2], X[C - 1 - k2])
        else:
            X, Y = column(u), column(P - u)
            for k2 in range(C):
                power[u + P * k2] = post(u + P * k2, X[k2], Y[C - 1 - k2])
                power[P - u + P * k2] = post(P - u + P * k2, Y[k2],
                                             X[C - 1 - k2])
    assert not np.isnan(power).any()
    return power if floor is None else np.maximum(power, floor)


def chirp_power(x, n_fft, c, bh, P=P_BLOCK):
    """The chirp-z route's power [n_fft/2 + 1] of one frame on a cluster of
    C = M / P blocks, in place in each block's P slots:
      1. a unit n1 < P reads a[n1 + P n2] = x_n c_n (n < L, folded) for
         n2 < C, takes their C-point DFT, multiplies by W_M^(n1 m2) and
         stores value m2 at slot n1 of rank m2 (across the cluster);
      2. rank m2's P-point FFT: A[C m1 + m2] at slot m1;
      3. times Bh in the decimated order Bh[m2 P + m1] = Bh[C m1 + m2],
         conjugated, in place;
      4. rank m2's P-point FFT again: U_m2[k1];
      5. a unit k1 reads slot k1 of every rank, times W_M^(c k1), a C-point
         DFT: y[k1 + P k2], and |y|^2 for the bins below n_fft/2 + 1."""
    M = len(bh)
    C = M // P
    assert C * P == M and 1 <= C <= MAX_RANKS
    L, nb = min(len(x), n_fft), n_fft // 2 + 1
    xf = np.zeros(L)
    xf[:] = x[:L]
    for t in range(n_fft, len(x), n_fft):
        xf[:min(L, len(x) - t)] += x[t:t + L][:L]
    a = np.zeros(M, np.complex128)
    a[:L] = xf * c
    tw = Twiddles(M)
    smem = blocks(C, P)
    ranks = np.arange(C)
    for n1 in range(P):  # 1.
        n = n1 + P * ranks
        t = np.where(n < L, a[np.minimum(n, M - 1)], 0)
        v = dft_regs(t) * tw(n1 * ranks)
        for m2 in ranks:
            smem[m2][slot(n1)] = v[m2]
    bh_dec = bh.reshape(P, C).T  # [m2][m1] = Bh[C m1 + m2]
    for m2 in ranks:  # 2.-4.
        block_fft(smem[m2], None, P, C, tw, first=False)
        s = slot(np.arange(P))
        smem[m2][s] = np.conj(smem[m2][s] * bh_dec[m2])
        block_fft(smem[m2], None, P, C, tw, first=False)
    power = np.full(nb, np.nan)
    for k1 in range(P):  # 5.
        t = np.array([smem[c_][slot(k1)] for c_ in ranks]) * tw(ranks * k1)
        y = dft_regs(t)
        k = k1 + P * ranks
        power[k[k < nb]] = abs(y[k < nb]) ** 2
    assert not np.isnan(power).any()
    return power


# -- the pieces ------------------------------------------------------------

def test_slots_and_registers():
    """The padded slots are distinct and fit P + P/16; the register DFT is
    the DFT at every radix the passes and the exchange take."""
    s = slot(np.arange(P_BLOCK))
    assert len(np.unique(s)) == P_BLOCK and s.max() < P_BLOCK * 17 // 16
    assert radices(P_BLOCK) == [8, 8, 8, 8, 4] and radices(16) == [8, 2]
    rng = np.random.RandomState(0)
    for R in (1, 2, 4, 8):
        v = rng.randn(3, R) + 1j * rng.randn(3, R)
        np.testing.assert_allclose(dft_regs(v), np.fft.fft(v, axis=-1),
                                   atol=1e-12)
    tw = Twiddles(1 << 17)
    m = rng.randint(0, 1 << 17, 1000)
    np.testing.assert_allclose(tw(m), np.exp(-2j * np.pi * m / (1 << 17)),
                               atol=1e-15)


@pytest.mark.parametrize("P,E", [(16384, 16384), (16384, 600), (64, 64),
                                 (64, 3)], ids=["16384", "16384_pruned",
                                                "64", "64_pruned"])
def test_block_fft_is_the_fft(P, E):
    """One block's passes in place, with the first pass pruned at E, equal
    numpy.fft.fft of the P values (zero past E)."""
    rng = np.random.RandomState(P + E)
    z = np.zeros(P, np.complex128)
    z[:E] = rng.randn(E) + 1j * rng.randn(E)
    buf = blocks(1, P)[0]
    block_fft(buf, lambda p: z[p], E, 1, Twiddles(P))
    got = buf[slot(np.arange(P))]
    want = np.fft.fft(z)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("H,P,J", [(16384, 16384, 16384),
                                   (32768, 16384, 32768),
                                   (32768, 16384, 600), (64, 16, 64),
                                   (64, 16, 7)],
                         ids=["16384_1rank", "32768_2ranks",
                              "32768_2ranks_pruned", "64_4ranks",
                              "64_4ranks_pruned"])
def test_cluster_fft_is_the_fft(H, P, J):
    """The cluster's complex spectrum before the post-step: rank c's block
    FFT of z[C p + c] (pruned at E_c), then the exchange's C-point DFTs of
    slot k1 across the ranks, X[k1 + P k2] = numpy.fft.fft(z) to float64
    rounding, at H = 16384 (one rank), 32768 (two) and 64 (four of 16)."""
    C = H // P
    rng = np.random.RandomState(H + J)
    z = np.zeros(H, np.complex128)
    z[:J] = rng.randn(J) + 1j * rng.randn(J)
    column = cluster_columns(z, J, C, P, Twiddles(H))
    got = np.empty(H, np.complex128)
    for k1 in range(P):
        got[k1 + P * np.arange(C)] = column(k1)
    want = np.fft.fft(z)
    assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("N,P,flen", [
    (32768, 16384, 32768), (32768, 16384, 1200), (65536, 16384, 65536),
    (65536, 16384, 1200), (128, 16, 128), (128, 16, 37), (256, 16, 256),
    (256, 16, 21)],
    ids=["32768_1rank", "32768_1rank_pruned", "65536_2ranks",
         "65536_2ranks_pruned", "H64_4ranks", "H64_4ranks_pruned",
         "H128_8ranks", "H128_8ranks_pruned"])
def test_cluster_spectrum_is_the_rfft_power(N, P, flen):
    """The cluster's power row (H = N/2 = C P points, C = 1, 2, 4, 8 ranks;
    a pruned first pass where the frame is shorter than N) equals
    |numpy.fft.rfft(x, N)|^2 to float64 rounding."""
    x = np.random.RandomState(flen).randn(flen)
    got = spectrum_power(x, N, P)
    want = np.abs(np.fft.rfft(x, N)) ** 2
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-10 * want.max()


@pytest.mark.parametrize("flen", [1200, 40000], ids=["1200", "folded_40000"])
def test_cluster_spectrum_of_a_frame_matches_the_plain_version(flen):
    """At N = 32768 the model's power row (the floor per bin) equals the FFT
    route's plain version (gpu_frontend._power: torch's f32 rfft of the
    folded frame) to f32 rounding, for a 48 kHz frame of 1200 samples and
    a frame longer than N (folded)."""
    x = (np.random.RandomState(flen).randn(flen) * 1000).astype(np.float32)
    got = spectrum_power(x.astype(np.float64), 32768, floor=1e-35)
    want = gpu_frontend._power(torch.from_numpy(x)[None], 32768)[0].numpy()
    assert np.abs(got - want).max() <= 2e-6 * want.max()


def _chirp_operators(fs, n_fft, nfilt):
    fe = text.FullFrontend(fs, tcfg.FeatureConfig(mfcc=tcfg.MfccConfig(
        fft_size=n_fft, n_filters=nfilt)), "cpu")
    return fe


@pytest.mark.parametrize("fs,n_fft,M", [(8000, 16000, 16384),
                                        (8000, 33000, 32768)],
                         ids=["16000_M16384", "33000_M32768"])
def test_cluster_chirp_matches_the_chirp_reference(fs, n_fft, M):
    """The model's in-place chirp convolution on the route's own f32 tables
    (chirp_tables) at M = 16384 (one block) and 32768 (two ranks), carried
    through the plain version's projection, log and DCT, equals
    mfcc_from_frames_chirp_reference on the same frames: the power to
    2e-6 of its largest, the cepstra to 1e-4 (the chirp's tolerance)."""
    fe = _chirp_operators(fs, n_fft, 26)
    assert gpu_frontend.chirp_size(n_fft, fe.frame_len) == M
    c, bh = (torch.view_as_complex(t).numpy().astype(np.complex128)
             for t in gpu_frontend.chirp_tables(n_fft, fe.frame_len))
    rng = np.random.RandomState(3)
    wp = (rng.randn(2, fe.frame_len) * 1000).astype(np.float32)
    power = np.stack([chirp_power(w.astype(np.float64), n_fft, c, bh)
                      for w in wp])
    want_p = gpu_frontend._chirp_power(torch.from_numpy(wp), n_fft).numpy()
    assert np.abs(power - want_p).max() <= 2e-6 * want_p.max()
    nb = n_fft // 2 + 1
    pw = torch.from_numpy(np.maximum(power, fe.floor).astype(np.float32))
    ceps = torch.log(torch.clamp_min(pw @ fe.mel[:nb], fe.floor)) @ fe.dct
    r = pw @ fe.acorr[:nb]
    wc, wr = gpu_frontend.mfcc_from_frames_chirp_reference(
        torch.from_numpy(wp), fe.mel, fe.dct, fe.floor, fe.acorr, n_fft)
    np.testing.assert_allclose(ceps.numpy(), wc.numpy(), rtol=0, atol=1e-4)
    np.testing.assert_allclose(r.numpy(), wr.numpy(), rtol=1e-5,
                               atol=1e-5 * float(wr.abs().max()))
