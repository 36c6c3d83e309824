"""The device-memory passes of csrc/rfft_passes.cuh modelled in float64
numpy, and the sums of the four-step route's fused pass split over the
bins (csrc/rfft_big.cuh; the split's rule itself is held in
tests/test_torch_cuda_standin.py, through the library's srt_big_ranges).

The passes take a transform of T = 2^lgt complex points (T = N/2 for K5's
real input past N = 262144, T = M for the chirp-z route past M = 131072) as
a matrix [T1][T2] in device memory, T1 = 2^(lgt - lgt/2) >= T2. The model
follows the kernels index by index: a block's shared-memory slots (one
float2 of padding after every 16 values and a few after each transform),
the batched Stockham passes of radix 8 (then 8, 4 or 2) in place with the
twiddles from the two-level table of W_T, the column pass's G adjacent
columns (a column with nothing past row 0 takes no FFT), the row pass of
K5 pairing rows k1 and T1 - k1 into the power rows, and the chirp's
forward, pointwise, forward order (the row pass holding both row FFTs).
It is held to numpy.fft; the CUDA sources run on the card (chip_smoke.py
phases 15 and 16) and, built with g++ against a stand-in runtime, on the CPU
(tests/test_torch_cuda_standin.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from speaker_recognition_tpu_torch.ops import gpu_frontend  # noqa: E402

# csrc/rfft_passes.cuh: values a block, its threads, its slots
P, NTH = 16384, 512
SLOTS = P + P // 16 + 32


def lg2(x):
    return x.bit_length() - 1


def pad_col(lg):
    return max(1, (1 << lg) >> 10)


def pad_row(lg):
    return max(1, (1 << lg) >> 9)


def slot(i, LG, PAD):
    """The slot of value i of a block of transforms of 2^LG values."""
    i = np.asarray(i)
    return i + (i >> 4) + (i >> LG) * PAD


class Twiddles:
    """W_T^m = hi[m >> lgb] lo[m & (2^lgb - 1)], lgb = ceil(lg T / 2)."""

    def __init__(self, T):
        lg = lg2(T)
        self.lgb, self.T = (lg + 1) // 2, T
        self.lo = np.exp(-2j * np.pi * np.arange(1 << self.lgb) / T)
        self.hi = np.exp(-2j * np.pi * np.arange(T >> self.lgb)
                         * (1 << self.lgb) / T)

    def __call__(self, m):
        m = np.asarray(m)
        assert (m >= 0).all() and (m < self.T).all()
        return self.hi[m >> self.lgb] * self.lo[m & ((1 << self.lgb) - 1)]


def dft_regs(v):
    """DFT_R over the last axis as the registers compute it (cfft::dft):
    radix-2 decimation in frequency, outputs read back from their
    bit-reversed places."""
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
    lg = lg2(R)
    order = [int(format(q, f"0{lg}b")[::-1], 2) if lg else 0
             for q in range(R)]
    return v[..., order]


def radices(L):
    """passes::ffts: radix 8 at Ns = 1, 8, 64, then what is left of 2^9 ..
    2^12 points."""
    rest = lg2(L) - 9
    return [8, 8, 8] + ([1 << rest] if rest else [])


def ffts(buf, LG, PAD, tw, lgt):
    """The block's 2^LG-point FFTs of its G = P / 2^LG transforms in place:
    butterfly j of transform g = j / S (S = 2^LG / R) loads values jj + S r
    (jj = j mod S), times W_T^((j mod Ns) r T / (Ns R)), DFT_R, stores at
    (jj - j mod Ns) R + j mod Ns + q Ns of its transform."""
    L, Ns = 1 << LG, 1
    for R in radices(L):
        S = L // R
        j = np.arange(P // R)
        g, jj, k = j // S, j % S, j & (Ns - 1)
        src = (g * L + jj)[:, None] + S * np.arange(R)[None, :]
        e = (k << (lgt - lg2(Ns * R)))[:, None] * np.arange(R)[None, :]
        out = dft_regs(buf[slot(src, LG, PAD)] * tw(e))
        dst = (g * L + (jj - k) * R + k)[:, None] + Ns * np.arange(R)[None, :]
        assert len(np.unique(dst)) == P and np.isfinite(out).all()
        buf[slot(dst, LG, PAD)] = out
        Ns *= R
    return buf


def shape(lgt):
    return 1 << (lgt - lgt // 2), 1 << (lgt // 2)


def column_pass(load, rows, store, lgt, tw):
    """passes::column_kernel over one frame: block d0 = G x loads value (n1,
    d) = load(T2 n1 + d) for n1 < E = min(rows(d0), T1) (only row 0 where E
    <= 1) into slot g T1 + n1 (g = d - d0), takes the T1-point FFTs where E
    > 1, and hands value k1 of column d (value 0 where E <= 1) to store."""
    T1, T2 = shape(lgt)
    LG1, G = lg2(T1), P // T1
    PAD = pad_col(LG1)
    i = np.arange(P)
    g, n1 = i & (G - 1), i >> (14 - LG1)
    for d0 in range(0, T2, G):
        buf = np.full(SLOTS, np.nan, np.complex128)
        E = min(rows(d0, T2), T1)
        sel = i < (P if E > 1 else G)
        vals = np.zeros(P, np.complex128)
        live = sel & (n1 < E)
        vals[live] = load(T2 * n1[live] + d0 + g[live])
        buf[slot(g[sel] * T1 + n1[sel], LG1, PAD)] = vals[sel]
        if E > 1:
            ffts(buf, LG1, PAD, tw, lgt)
        src = g * T1 + (n1 if E > 1 else 0)  # n1 here is the output k1
        store(n1, d0 + g, buf[slot(src, LG1, PAD)])


def twiddled(lgt, tw):
    """The column pass's store into [k1][d], times W_T^(d k1); returns the
    matrix and the store."""
    T1, T2 = shape(lgt)
    Y = np.full((T1, T2), np.nan, np.complex128)

    def store(k1, d, v):
        Y[k1, d] = v * tw(d * k1)
    return Y, store


def fold(x, N, L):
    xf = np.zeros(L)
    xf[:] = x[:L]
    for t in range(N, len(x), N):
        xf[:min(L, len(x) - t)] += x[t:t + L][:L]
    return xf


def direct_rows(load, J, lgt, tw):
    """passes::load_rows straight from the frame (in.count() = J <= T2):
    value n of row k1 = load(n) W_T^(n k1) for n < J, zero past it; the
    matrix the column pass would have left."""
    T1, T2 = shape(lgt)
    assert J <= T2
    Y = np.zeros((T1, T2), np.complex128)
    n = np.arange(J)
    Y[:, :J] = load(n)[None, :] * tw(np.arange(T1)[:, None] * n[None, :])
    return Y


def real_power(x, N, direct=False):
    """K5's power row [N/2 + 1] on the passes: the column pass over z[j] =
    x[2j] + i x[2j+1] (rows past J = ceil(min(flen, N) / 2) zero), then
    passes::power_rows_kernel: block x takes units u = U x + gi of rows u
    and T1 - u (row T1/2 for u = 0), their T2-point FFTs, and the post-step
    power of bins u + T1 k2 and T1 - u + T1 k2 (u = 0: T1 k2, H, T1/2 + T1
    k2) from Z[k] and Z[H - k]."""
    H = N // 2
    lgt = lg2(H)
    T1, T2 = shape(lgt)
    L = min(len(x), N)
    xf = np.zeros(N)
    xf[:L] = fold(x, N, L)
    z = xf[0::2] + 1j * xf[1::2]
    J = (L + 1) // 2
    tw = Twiddles(H)
    Y, store = twiddled(lgt, tw)
    column_pass(lambda j: z[j], lambda d0, t2: max(0, -(-(J - d0) // t2)),
                store, lgt, tw)
    assert np.isfinite(Y).all()
    if direct:  # the same values, straight from the frame
        Yd = direct_rows(lambda j: z[j], J, lgt, tw)
        assert np.array_equal(Yd, Y)
        Y = Yd
    LG2, G = lg2(T2), P // T2
    U, PAD = G // 2, pad_row(LG2)
    power = np.full(H + 1, np.nan)
    wN = np.exp(-1j * np.pi * np.arange(H + 1) / H)  # W_N^k

    def post(k, a, b):
        assert np.isnan(power[k]).all()
        e = 0.5 * (a + np.conj(b))
        o = -0.5j * (a - np.conj(b))
        power[k] = abs(e + wN[k] * o) ** 2

    i = np.arange(P)
    for b in range(T1 // G):
        u0 = U * b
        gi = np.arange(G)
        u = u0 + (gi & (U - 1))
        rows = np.where(gi < U, u, np.where(u == 0, T1 // 2, T1 - u))
        buf = np.full(SLOTS, np.nan, np.complex128)
        buf[slot(i, LG2, PAD)] = Y[rows[i >> LG2], i & (T2 - 1)]
        ffts(buf, LG2, PAD, tw, lgt)
        w = np.arange(U * T2)
        gi, k2 = w & (U - 1), w >> lg2(U)
        u = u0 + gi

        def lo(k):
            return buf[slot(gi * T2 + k, LG2, PAD)]

        def hi(k):
            return buf[slot((gi + U) * T2 + k, LG2, PAD)]
        a, ka, kb = lo(k2), hi(T2 - 1 - k2), lo(np.maximum(T2 - k2, 0) % T2)
        zero = u == 0
        first = zero & (k2 == 0)
        if first.any():
            z0 = a[first][0]
            power[0], power[H] = (z0.real + z0.imag) ** 2, (
                z0.real - z0.imag) ** 2
        r0 = zero & (k2 > 0)
        post(T1 * k2[r0], a[r0], kb[r0])
        post(T1 // 2 + T1 * k2[zero], hi(k2)[zero], hi(T2 - 1 - k2)[zero])
        on = ~zero
        post((u + T1 * k2)[on], a[on], ka[on])
        post((T1 - u + T1 * k2)[on], hi(k2)[on], lo(T2 - 1 - k2)[on])
    assert not np.isnan(power).any()
    return power


def chirp_tables64(n_fft, flen):
    """c [L] and Bh [M] of gpu_frontend.chirp_tables in float64."""
    L, nb = min(flen, n_fft), n_fft // 2 + 1
    M = gpu_frontend.chirp_size(n_fft, flen)
    j = np.arange(max(L, nb), dtype=np.int64)
    c = np.exp(-1j * np.pi * ((j * j) % (2 * n_fft)) / n_fft)
    b = np.zeros(M, np.complex128)
    b[:nb] = np.conj(c[:nb])
    b[M - L + 1:] = np.conj(c[1:L])[::-1]
    return c[:L], np.fft.fft(b) / M


def chirp_power(x, n_fft, c, bh):
    """The chirp-z route's power [n_fft/2 + 1] on the passes (csrc/
    frontend_chirp_cluster.cu past M = 131072):
      1. the column pass over a_j = x_j c_j (j < L, folded; rows past L
         zero), times W_M^(d k1), into [k1][d];
      2. passes::chirp_rows_kernel: rows r0 .. r0 + G - 1, each one's
         M2-point FFT (A[k1 + M1 k2] at [k1][k2]), times Bh as [M1][M2],
         conjugated (w[a + M1 b] at [a][b]), the M2-point FFTs again, times
         W_M^(a d), in place;
      3. the column pass over a: y[d + M2 c] as |y|^2 of the bins below
         n_fft/2 + 1."""
    M = len(bh)
    lgm = lg2(M)
    M1, M2 = shape(lgm)
    L, nb = min(len(x), n_fft), n_fft // 2 + 1
    a = np.zeros(M, np.complex128)
    a[:L] = fold(x, n_fft, L) * c
    tw = Twiddles(M)
    Y, store = twiddled(lgm, tw)
    column_pass(lambda j: a[j], lambda d0, t2: max(0, -(-(L - d0) // t2)),
                store, lgm, tw)
    if L <= M2:  # a short frame: the row pass loads straight from it
        Yd = direct_rows(lambda j: a[j], L, lgm, tw)
        assert np.array_equal(Yd, Y)
        Y = Yd
    bhp = bh.reshape(M2, M1).T  # [k1][k2] = Bh[k1 + M1 k2]
    LG2, G = lg2(M2), P // M2
    PAD = pad_row(LG2)
    i = np.arange(P)
    for r0 in range(0, M1, G):
        buf = np.full(SLOTS, np.nan, np.complex128)
        s = slot(i, LG2, PAD)
        buf[s] = Y[r0 + (i >> LG2), i & (M2 - 1)]
        ffts(buf, LG2, PAD, tw, lgm)
        buf[s] = np.conj(buf[s] * bhp[r0 + (i >> LG2), i & (M2 - 1)])
        ffts(buf, LG2, PAD, tw, lgm)
        Y[r0 + (i >> LG2), i & (M2 - 1)] = buf[s] * tw(
            (r0 + (i >> LG2)) * (i & (M2 - 1)))
    power = np.full(nb, np.nan)

    def out(cc, d, y):
        k = d + M2 * cc
        power[k[k < nb]] = abs(y[k < nb]) ** 2
    column_pass(lambda j: Y.reshape(-1)[j], lambda d0, t2: M1, out, lgm, tw)
    assert not np.isnan(power).any()
    return power


# -- the pieces ------------------------------------------------------------

@pytest.mark.parametrize("LG", [9, 10, 11, 12])
def test_block_ffts_are_the_fft(LG):
    """A block's G = 16384 / 2^LG transforms of 2^LG points, the twiddles
    from a table of W_T at the largest T that uses this sub-FFT size, equal
    numpy.fft per transform; the slots stay inside the block's buffer and
    every pass writes every value once."""
    L, G = 1 << LG, P >> LG
    lgt = {9: 18, 10: 20, 11: 22, 12: 23}[LG]
    for PAD in {pad_col(LG), pad_row(LG)}:
        assert slot(P - 1, LG, PAD) < SLOTS and G * PAD <= 32
        rng = np.random.RandomState(LG)
        x = rng.randn(P) + 1j * rng.randn(P)
        buf = np.full(SLOTS, np.nan, np.complex128)
        buf[slot(np.arange(P), LG, PAD)] = x
        ffts(buf, LG, PAD, Twiddles(1 << lgt), lgt)
        got = buf[slot(np.arange(P), LG, PAD)].reshape(G, L)
        want = np.fft.fft(x.reshape(G, L), axis=1)
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()


@pytest.mark.parametrize("LG", [9, 10, 11, 12])
def test_slots_spread_the_banks(LG):
    """A half-warp's 16 float2 accesses fall in 16 distinct bank pairs in
    the column pass (consecutive threads on consecutive columns g of a row
    n1) and in the power rows (consecutive units gi at one k2), by the
    padding after each transform; and in each Stockham pass's loads."""
    t = np.arange(NTH)
    G = P >> LG
    if LG >= 9:  # the column pass: value g T1 + n1 of thread i = (n1, g)
        i = t
        g, n1 = i & (G - 1), i >> (14 - LG)
        s = slot(g * (1 << LG) + n1, LG, pad_col(LG)) % 16
        assert all(len(set(s[h:h + 16])) == 16 for h in range(0, NTH, 16))
    if LG <= 11:  # the power rows: unit gi, bin k2
        U = G // 2
        gi, k2 = t & (U - 1), t >> lg2(U)
        s = slot(gi * (1 << LG) + k2, LG, pad_row(LG)) % 16
        assert all(len(set(s[h:h + 16])) == 16 for h in range(0, NTH, 16))
    for R in radices(1 << LG):
        S = (1 << LG) // R
        for PAD in {pad_col(LG), pad_row(LG)}:
            s = slot((t // S) * (1 << LG) + (t % S), LG, PAD) % 16
            assert all(len(set(s[h:h + 16])) == 16
                       for h in range(0, NTH, 16))


def test_transform_shapes_and_groups():
    """T1 >= T2, both 512 .. 4096, for every transform the passes take (N
    = 524288 .. 2^24, M = 262144 .. 2^23); G = 16384 / T1 >= 4 adjacent
    columns a block (32-byte sectors); a group of frames' matrices fills at
    most 32 MB of the L2 (at least one frame)."""
    for lgt in range(18, 24):
        T1, T2 = shape(lgt)
        assert T1 * T2 == 1 << lgt and 512 <= T2 <= T1 <= 4096
        assert P // T1 >= 4 and (P // T2) % 2 == 0
        assert gpu_frontend.passes_shape(1 << lgt) == (T1, T2)
        group = max(1, (32 << 20) >> (lgt + 3))
        assert group * 8 << lgt <= max(32 << 20, 8 << lgt)


# -- the whole transforms --------------------------------------------------

@pytest.mark.parametrize("N,flen", [(524288, 1536), (524288, 256),
                                    (1 << 20, (1 << 20) + 3000),
                                    (1 << 22, 5000)],
                         ids=["524288", "524288_short", "1048576_folded",
                              "4194304"])
def test_real_power_rows_are_the_rfft_power(N, flen):
    """K5's column pass (pruned where a column has nothing past row 0; for
    a short frame, 256 samples, the row pass's loads straight from the
    frame, which equal the column pass's matrix exactly) and the paired
    row pass give |rfft(x, N)|^2 of the folded frame to 1e-10 of its
    largest bin, at sub-FFT sizes 512 x 512, 1024 x 512 (the row pass's
    radix 2 in the column) and 2048 x 1024 (radix 4, radix 2)."""
    x = np.random.RandomState(flen).randn(flen)
    got = real_power(x, N, direct=(min(flen, N) + 1) // 2 <= shape(
        lg2(N // 2))[1])
    xf = np.zeros(N)
    L = min(flen, N)
    xf[:L] = fold(x, N, L)
    want = np.abs(np.fft.rfft(xf)) ** 2
    assert np.abs(got - want).max() <= 1e-10 * want.max()


@pytest.mark.parametrize("n_fft,flen,M", [(261634, 256, 262144),
                                          (600000, 3000, 524288)],
                         ids=["261634", "600000_long_frame"])
def test_chirp_on_the_passes_is_the_dft(n_fft, flen, M):
    """The chirp-z route on the passes (forward FFT over x c, times Bh,
    conjugated, the forward FFT again: the row pass holds both row FFTs)
    gives |DFT_N(x)|^2 to 1e-10 of its largest bin, and equals
    gpu_frontend._chirp_power's order of operations in float64; at 256
    samples the row pass loads straight from the frame (the column pass's
    matrix exactly), at 3000 the column pass takes its FFTs (L > M2)."""
    assert gpu_frontend.chirp_size(n_fft, flen) == M
    c, bh = chirp_tables64(n_fft, flen)
    x = np.random.RandomState(n_fft % 1000).randn(flen)
    got = chirp_power(x, n_fft, c, bh)
    want = np.abs(np.fft.rfft(x, n=n_fft)) ** 2
    assert np.abs(got - want).max() <= 1e-10 * want.max()
    a = np.zeros(M, np.complex128)
    a[:len(c)] = x[:len(c)] * c
    y = np.fft.fft(np.conj(np.fft.fft(a) * bh))[:n_fft // 2 + 1]
    assert np.abs(got - abs(y) ** 2).max() <= 1e-10 * want.max()


def test_chirp_bh_in_the_passes_order():
    """chirp_cluster_bh past M = 131072 is Bh as [M1][M2]: Bh[k1 + M1 k2] at
    [k1][k2], the place of A[k1 + M1 k2] after the row pass; up to 131072
    the cluster's decimated order."""
    n_fft, flen = 261634, 256
    _, bh = gpu_frontend.chirp_tables(n_fft, flen)
    M1, M2 = gpu_frontend.passes_shape(bh.shape[0])
    got = gpu_frontend.chirp_cluster_bh(n_fft, flen)
    assert got.shape == (M1, M2, 2)
    for k1, k2 in ((0, 0), (1, 0), (0, 1), (M1 - 1, M2 - 1), (37, 400)):
        assert torch.equal(got[k1, k2], bh[k1 + M1 * k2])
    assert gpu_frontend.chirp_cluster_bh(33000, 256).shape == (2, 16384, 2)


# -- the fused pass's split --------------------------------------------------

def test_split_partials_in_order_equal_the_unsplit_sum():
    """The fused pass's sum of an output over the bins, split into S ranges
    (each range summed in order in f32, then the S partials added in the
    order s = 0 .. S - 1), equals the unsplit f32 sum in order within f32
    rounding of the sum of the terms' magnitudes, and both are within it
    of the float64 sum. The ranges are those of 62 frames at 262144
    points: 29 of 4,608 bins (the rule's values are held in
    tests/test_torch_cuda_standin.py)."""
    rng = np.random.RandomState(3)
    nb = 131073
    S, r = 29, 4608
    assert (S - 1) * r < nb <= S * r
    p = rng.rand(nb).astype(np.float32) * 1e4
    w = (rng.randn(nb) * (rng.rand(nb) < 0.3)).astype(np.float32)
    terms = p * w  # f32 products, as the kernel's fmaf rounds them once

    def seq(x):
        return np.cumsum(x, dtype=np.float32)[-1]
    unsplit = seq(terms)
    parts = [seq(terms[s * r:(s + 1) * r]) for s in range(S)]
    split = np.float32(0)
    for q in parts:
        split = np.float32(split + q)
    exact = float(np.sum(p.astype(np.float64) * w.astype(np.float64)))
    bound = nb * 2.0 ** -24 * float(np.abs(p.astype(np.float64) * w).sum())
    assert abs(float(split) - float(unsplit)) <= 2 * bound
    assert abs(float(split) - exact) <= bound
    assert abs(float(unsplit) - exact) <= bound


def test_the_ablation_variants_apply():
    """Every variant of tools/fft_ablation.py edits text that its copy of
    the sources still holds when its turn comes (build applies a variant's
    edits in order and stops the tool, on the card, at one that no longer
    applies)."""
    import os

    from speaker_recognition_tpu_torch import _build
    from speaker_recognition_tpu_torch.tools import fft_ablation as fa

    for variants, common in ((fa.VARIANTS, ()), (fa.BIG_VARIANTS, ()),
                             (fa.CHIRP_VARIANTS, fa.CHIRP_ONE),
                             (fa.CHIRP_CLUSTER_VARIANTS, fa.CLUSTER_ONE),
                             (fa.CHIRP_PASSES_VARIANTS, fa.CLUSTER_ONE),
                             (fa.DENSE_VARIANTS, ()),
                             (fa.SIGNAL_VARIANTS, fa.SIGNAL_ONE),
                             (fa.LPCC_VARIANTS, fa.LPCC_ONE)):
        for name, edits in variants.items():
            srcs = {}
            for edit in (*common, *edits):
                fname, old, new = (edit if len(edit) == 3
                                   else ("rfft_tile.cuh", *edit))
                if fname not in srcs:
                    with open(os.path.join(_build.CSRC, fname)) as f:
                        srcs[fname] = f.read()
                assert old in srcs[fname], (name, fname, old[:60])
                srcs[fname] = srcs[fname].replace(old, new)
