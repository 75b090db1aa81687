"""The recurrences of the port against the JAX package and float64 models:
``ops.cma_equalize`` (kernel F) and ``ops.iir_filter`` (kernel G), on the
kernels' plain versions (the CPU route).

Tolerances.  XLA's CPU backend contracts a*b+c into FMAs and sums in its
own order, and the port rounds every f32 operation on its own in a fixed
order, so the two packages are not held bit for bit: a float64 model of
the same recurrence is the arbiter.  The port's y and final taps are held
within 1e-5 of max|y| (max|taps|) of the float64 model and of the JAX
package (both measured at <= 3.4e-6 on these inputs, n = 4096), the IIR
filter within 5e-6 of max|y| (<= 7e-7 measured); the reference's IIR
goldens exactly.  The plain versions are held bit for bit to a numpy f32
restatement of the kernels' order of operations: what the card holds the
kernels to (tests/test_torch_cuda.py, chip_smoke.py).  Both kernels
compute a blocked form of their recurrence, so the sequential f32 forms
(``cma_kernel_order``, ``iir_kernel_order``) hold only their first window
or chunk bit for bit, and the rest within the tolerances above.
"""

import numpy as np
import pytest
import torch
from scipy import signal

from rustradio_tpu import ops as jops
from rustradio_tpu_torch import ops
from rustradio_tpu_torch.ops import kernels

CPU = "cpu"
N = 4096
CMA_TOL = 1e-5
IIR_TOL = 5e-6


def cma_input(rng, n):
    """Unit-modulus QPSK through a two-path channel (gain 0.5, an echo two
    samples ahead at 0.2) plus complex noise of 0.01."""
    s = np.exp(2j * np.pi * rng.randint(0, 4, n + 2) / 4)
    x = 0.5 * s[:n] + 0.2 * np.exp(0.7j) * s[2:] + 0.01 * (
        rng.randn(n) + 1j * rng.randn(n))
    return x.astype(np.complex64)


def cma_f64(x, ntaps, r, mu, taps=None):
    x = x.astype(np.complex128)
    t = np.zeros(ntaps, np.complex128)
    t[0] = 1.0
    if taps is not None:
        t = np.asarray(taps, np.complex128)
    ys = []
    for i in range(len(x) - ntaps + 1):
        w = x[i : i + ntaps]
        y = np.sum(t * w)
        e = r - abs(y) ** 2
        t = t + (mu * e) * y * np.conj(w)
        ys.append(y)
    return np.asarray(ys), t


def iir_f64(x, taps, history=None):
    taps = np.asarray(taps, np.float64)
    order = len(taps) - 1
    if order == 0:
        return taps[0] * np.asarray(x, np.float64)
    h = np.zeros(order) if history is None else np.asarray(history, np.float64)
    ys = []
    for v in x:
        y = taps[0] * v + np.dot(taps[1:], h)
        h = np.concatenate([[y], h[:-1]])
        ys.append(y)
    return np.asarray(ys)


def rel(a, b, scale):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()) / scale


@pytest.mark.parametrize("ntaps", [1, 2, 4, 16, 40])
@pytest.mark.parametrize("mu", [0.0, 1e-3, 1e-2])
@pytest.mark.parametrize("given", [False, True], ids=["default_taps", "taps"])
def test_torch_cma_equalize_matches_jax_and_float64(ntaps, mu, given):
    rng = np.random.RandomState(ntaps + int(mu * 1e4))
    x = cma_input(rng, N)
    taps = None
    if given:
        taps = ((0.5 * rng.randn(ntaps) + 0.5j * rng.randn(ntaps))
                / np.sqrt(ntaps)).astype(np.complex64)
    y, fin = ops.cma_equalize(x, ntaps, 1.0, mu, taps=taps, device=CPU)
    assert y.shape == (N - ntaps + 1,) and y.dtype == torch.complex64
    jy, jfin = jops.cma_equalize(x, ntaps, 1.0, mu, taps=taps)
    fy, ffin = cma_f64(x, ntaps, 1.0, mu, taps)
    sy, st = np.abs(fy).max(), np.abs(ffin).max()
    assert rel(y.numpy(), fy, sy) <= CMA_TOL
    assert rel(fin.numpy(), ffin, st) <= CMA_TOL
    assert rel(y.numpy(), np.asarray(jy), sy) <= CMA_TOL
    assert rel(fin.numpy(), np.asarray(jfin), st) <= CMA_TOL


def test_torch_cma_equalize_passthrough_and_errors():
    x = cma_input(np.random.RandomState(0), 1000)
    y, fin = ops.cma_equalize(x, 4, 1.0, 0.0, device=CPU)
    assert np.array_equal(y.numpy(), x[:997])  # exact at mu = 0
    assert np.array_equal(fin.numpy(), np.eye(1, 4)[0])
    with pytest.raises(ValueError, match="nonzero"):
        ops.cma_equalize(x, 0, device=CPU)
    with pytest.raises(ValueError, match="shorter than taps"):
        ops.cma_equalize(x[:3], 4, device=CPU)
    with pytest.raises(ValueError, match="device="):
        ops.cma_equalize(x, 4)  # a numpy input names its device
    with pytest.raises(ValueError, match="1..128 taps"):
        ops.cma_equalize(np.zeros(300, np.complex64), 129, device=CPU)
    with pytest.raises(ValueError, match="taps of shape"):
        ops.cma_equalize(x, 4, taps=np.ones(3, np.complex64), device=CPU)


def cma_kernel_order(x, taps, r, mu):
    """numpy f32 restatement of the sequential recurrence in 32 lanes,
    window after window: lane l's taps l, l + 32, ...; its sum from +0.0
    over its taps in that order; the lanes folded by a butterfly (16, 8,
    4, 2, 1); then e, mu * e * y and each tap's update.  Kernel F's first
    window of a call (a base) is this form's."""
    f = np.float32
    r, mu = f(r), f(mu)
    ntaps = len(taps)
    tr = [f(t.real) for t in taps]
    ti = [f(t.imag) for t in taps]
    ys = []
    for i in range(len(x) - ntaps + 1):
        w = x[i : i + ntaps]
        wr = [f(v.real) for v in w]
        wi = [f(v.imag) for v in w]
        ar, ai = [f(0.0)] * 32, [f(0.0)] * 32
        for k in range(ntaps):
            lane = k % 32
            ar[lane] = ar[lane] + (tr[k] * wr[k] - ti[k] * wi[k])
            ai[lane] = ai[lane] + (tr[k] * wi[k] + ti[k] * wr[k])
        for off in (16, 8, 4, 2, 1):
            ar = [ar[l] + ar[l ^ off] for l in range(32)]
            ai = [ai[l] + ai[l ^ off] for l in range(32)]
        yr, yi = ar[0], ai[0]
        e = r - (yr * yr + yi * yi)
        me = mu * e
        cr, ci = me * yr, me * yi
        for k in range(ntaps):
            tr[k] = tr[k] + (cr * wr[k] + ci * wi[k])
            ti[k] = ti[k] + (ci * wr[k] - cr * wi[k])
        ys.append(complex(yr, yi))
    return (np.asarray(ys, np.complex64),
            (np.asarray(tr, np.float32) + 1j * np.asarray(ti, np.float32)
             ).astype(np.complex64))


K = kernels.CMA_BLOCK


def cma_blocked_numpy(x, taps, r, mu):
    """numpy f32 restatement of csrc/cma.cu's delayed-update form: blocks of
    K windows from the call's start; for each, with the taps t_B it starts
    from,

    1. the bases a_n = t_B . w_n: 32 lane sums, lane l from +0.0 over the
       products of taps l, l + 32, ... (only taps < ntaps), then the lanes
       folded in halves (16, 8, 4, 2, 1);
    2. G[m, j] = sum_k conj(x[m + k]) x[j + k] for m < j in the block, from
       the k = 0 product up;
    3. y_n = a_n + c_B G[B, n] + ... + c_{n-1} G[n-1, n], from the oldest
       term up, c = (mu * (R - |y|^2)) * y;
    4. the taps updated after each window, t += c conj(w)."""
    f = np.float32
    r, mu = f(r), f(mu)
    ntaps = len(taps)
    nwin = len(x) - ntaps + 1
    pad = np.zeros(len(x) + 2 * K + ntaps, np.complex64)
    pad[: len(x)] = x
    xr, xi = pad.real.astype(f), pad.imag.astype(f)
    tr, ti = taps.real.astype(f), taps.imag.astype(f)
    ys = np.empty(nwin, np.complex64)
    for b0 in range(0, nwin, K):
        cnt = min(K, nwin - b0)
        n = b0 + np.arange(cnt)
        lr, li = np.zeros((32, cnt), f), np.zeros((32, cnt), f)
        for k in range(ntaps):
            wr, wi = xr[n + k], xi[n + k]
            lr[k % 32] = lr[k % 32] + (tr[k] * wr - ti[k] * wi)
            li[k % 32] = li[k % 32] + (tr[k] * wi + ti[k] * wr)
        for off in (16, 8, 4, 2, 1):
            lr, li = lr[:off] + lr[off : 2 * off], li[:off] + li[off : 2 * off]
        pr, pi = lr[0], li[0]
        m, j = np.triu_indices(cnt, 1)
        m, j = b0 + m, b0 + j
        gr = xr[m] * xr[j] + xi[m] * xi[j]
        gi = xr[m] * xi[j] - xi[m] * xr[j]
        for k in range(1, ntaps):
            ar, ai, br, bi = xr[m + k], xi[m + k], xr[j + k], xi[j + k]
            gr = gr + (ar * br + ai * bi)
            gi = gi + (ar * bi - ai * br)
        g_r, g_i = np.zeros((cnt, cnt), f), np.zeros((cnt, cnt), f)
        g_r[m - b0, j - b0], g_i[m - b0, j - b0] = gr, gi
        for i in range(cnt):
            yr, yi = pr[i], pi[i]
            me = mu * (r - (yr * yr + yi * yi))
            cr, ci = me * yr, me * yi
            later = slice(i + 1, cnt)
            pr[later] = pr[later] + (cr * g_r[i, later] - ci * g_i[i, later])
            pi[later] = pi[later] + (cr * g_i[i, later] + ci * g_r[i, later])
            wr, wi = xr[b0 + i : b0 + i + ntaps], xi[b0 + i : b0 + i + ntaps]
            tr = tr + (cr * wr + ci * wi)
            ti = ti + (ci * wr - cr * wi)
            ys[b0 + i] = complex(yr, yi)
    return ys, (tr + 1j * ti).astype(np.complex64)


def cma_given_taps(rng, ntaps):
    return (np.eye(1, ntaps)[0] + 0.1 * (rng.randn(ntaps) + 1j * rng.randn(ntaps))
            / ntaps).astype(np.complex64)


@pytest.mark.parametrize("ntaps", [1, 16, 40, 70])
def test_torch_cma_plain_version_is_the_kernels_order(ntaps):
    # the plain version (the CPU route) against the kernel's arithmetic
    # restated in numpy f32 (the blocked form), bit for bit; its first
    # window, a base, against the sequential lane-by-lane form
    rng = np.random.RandomState(ntaps)
    x = cma_input(rng, ntaps + 299)
    taps = cma_given_taps(rng, ntaps)
    y, fin = kernels.cma_scan_plain(torch.from_numpy(x), torch.from_numpy(taps),
                                    1.0, 1e-2)
    wy, wfin = cma_blocked_numpy(x, taps, 1.0, 1e-2)
    assert np.array_equal(y.numpy(), wy) and np.array_equal(fin.numpy(), wfin)
    sy, _ = cma_kernel_order(x[:ntaps], taps, 1.0, 1e-2)
    assert np.array_equal(y.numpy()[:1], sy)


@pytest.mark.parametrize("nwin", [1, K - 1, K, K + 1, 5 * K + 7])
@pytest.mark.parametrize("ntaps", [1, 16, 40, 70, 128])
@pytest.mark.parametrize("given", [False, True], ids=["default_taps", "taps"])
def test_torch_cma_plain_is_the_numpy_restatement(nwin, ntaps, given):
    rng = np.random.RandomState(ntaps + nwin)
    x = cma_input(rng, nwin + ntaps - 1)
    taps = (cma_given_taps(rng, ntaps) if given
            else np.eye(1, ntaps)[0].astype(np.complex64))
    y, fin = kernels.cma_scan_plain(torch.from_numpy(x), torch.from_numpy(taps),
                                    1.0, 1e-2)
    wy, wfin = cma_blocked_numpy(x, taps, 1.0, 1e-2)
    assert y.shape == (nwin,)
    assert np.array_equal(y.numpy(), wy) and np.array_equal(fin.numpy(), wfin)


@pytest.mark.parametrize("ntaps", [1, 16, 40, 128])
@pytest.mark.parametrize("mu", [1e-3, 1e-2])
def test_torch_cma_plain_blocked_vs_float64_and_sequential(ntaps, mu):
    # the blocked form is the sequential recurrence's function rounded in
    # another order: within CMA_TOL of float64 and of the sequential f32
    # form, and its first window (a base) is the sequential form's
    rng = np.random.RandomState(ntaps)
    x = cma_input(rng, 6 * K + 11 + ntaps - 1)
    taps = cma_given_taps(rng, ntaps)
    y, fin = kernels.cma_scan_plain(torch.from_numpy(x), torch.from_numpy(taps),
                                    1.0, mu)
    fy, ffin = cma_f64(x, ntaps, 1.0, mu, taps)
    sy, sfin = cma_kernel_order(x, taps, 1.0, mu)
    scale, tscale = np.abs(fy).max(), np.abs(ffin).max()
    assert rel(y.numpy(), fy, scale) <= CMA_TOL
    assert rel(fin.numpy(), ffin, tscale) <= CMA_TOL
    assert rel(y.numpy(), sy, scale) <= CMA_TOL
    assert rel(fin.numpy(), sfin, tscale) <= CMA_TOL
    assert y.numpy()[0] == sy[0]


@pytest.mark.parametrize("ntaps", [1, 16, 40])
def test_torch_cma_plain_splits_at_a_block_edge_exactly(ntaps):
    # blocks count from a call's start: a call split after a multiple of K
    # windows, the taps carried, gives the one call's outputs bit for bit
    rng = np.random.RandomState(5)
    x = torch.from_numpy(cma_input(rng, 7 * K + 3 + ntaps - 1))
    t0 = torch.from_numpy(cma_given_taps(rng, ntaps))
    y, fin = kernels.cma_scan_plain(x, t0, 1.0, 1e-2)
    cut = 4 * K
    y1, t1 = kernels.cma_scan_plain(x[: cut + ntaps - 1], t0, 1.0, 1e-2)
    y2, t2 = kernels.cma_scan_plain(x[cut:], t1, 1.0, 1e-2)
    assert torch.equal(torch.cat([y1, y2]), y) and torch.equal(t2, fin)


IIR_TAPS = {
    0: [0.7],
    1: [0.1, 0.9],
    2: [0.05, 1.6, -0.65],  # poles 0.8 +- 0.1j
    # poles 0.95 e^{+-0.3j}, 0.9 e^{+-0.9j}, 0.85 e^{+-1.6j}, 0.8 e^{+-2.4j},
    # unit gain at DC
    8: [0.3017025, 1.7045681, -1.5572132, 1.1628689, -0.8696898, 0.672317,
        -0.5769415, 0.500414, -0.33802596],
}


@pytest.mark.parametrize("order,with_history", [
    (0, False), (1, False), (1, True), (2, False), (2, True), (8, False),
    (8, True)])
def test_torch_iir_filter_matches_jax_and_float64(order, with_history):
    rng = np.random.RandomState(order)
    taps = np.asarray(IIR_TAPS[order], np.float32)
    x = rng.randn(N).astype(np.float32)
    hist = rng.randn(order).astype(np.float32) if with_history else None
    y = ops.iir_filter(x, taps, hist, device=CPU)
    assert y.shape == (N,) and y.dtype == torch.float32
    jy = np.asarray(jops.iir_filter(x, taps, hist))
    fy = iir_f64(x, taps, hist)
    scale = np.abs(fy).max()
    assert rel(y.numpy(), fy, scale) <= IIR_TOL
    assert rel(y.numpy(), jy, scale) <= IIR_TOL
    if order == 0:  # x * taps[0] in both packages
        assert np.array_equal(y.numpy(), jy)


def test_torch_iir_filter_goldens_exactly():
    # reference src/iir_filter.rs:171-194
    got = ops.iir_filter(np.full(4, 100.0, np.float32), [1.0, 0.9, 0.1], device=CPU)
    assert np.array_equal(got.numpy(), np.float32([100.0, 190.0, 281.0, 371.9]))
    got = ops.iir_filter(np.asarray([100.0, 100.0, 200.0], np.float32),
                         [1.0, 0.9, 0.1], history=[100.0, 100.0], device=CPU)
    assert np.array_equal(got.numpy(), np.float32([200.0, 290.0, 481.0]))
    with pytest.raises(ValueError, match="orders 1..32"):
        ops.iir_filter(torch.zeros(8), np.full(34, 0.01))


def iir_kernel_order(x, taps, hist):
    """numpy f32 restatement of csrc/iir.cu: taps[0] * x[n], then the
    terms from the oldest output down to taps[2] * y[n - 2], then
    taps[1] * y[n - 1] last."""
    t = [np.float32(v) for v in taps]
    h = [np.float32(v) for v in hist]
    ys = []
    for v in x:
        acc = t[0] * np.float32(v)
        for i in range(len(t) - 1, 1, -1):
            acc = acc + t[i] * h[i - 1]
        y = acc + t[1] * h[0]
        h = [y] + h[:-1]
        ys.append(y)
    return np.asarray(ys, np.float32)


L = kernels.IIR_CHUNK
B = kernels.IIR_BLOCK


def iir_blocked_numpy(x, taps, hist):
    """numpy f32 restatement of csrc/iir.cu's three passes (chunks of L
    samples, blocks of B chunks, the f32 powers P of kernels.iir_powers,
    each product's row sums times 2^E[j], E of kernels.iir_exponents):

    1. each chunk's walk from zeros (chunk 0 from the history), in
       iir_kernel_order's order, vectorised over the chunks; within each
       block, for j = 0..6, u[i] += P[j] @ u[i - 2^j] where i >= 2^j;
    2. the blocks' last u (but the last block's) scanned the same way in
       tiles of B with P[7 + j], and from the second tile on each entry i
       plus (P[7 + j] for the set bits j of i + 1, lowest first) applied
       to the previous tile's last entry;
    3. each chunk's start: the history; u[k - 1] in block 0; the carry into
       its block at i = 0; else u[k - 1] + (P[j] for the bits of i) carry;
       then the walk again.

    A matrix row sums its products from column 0 up."""
    f = np.float32
    t = np.asarray(taps, f)
    p, n = len(t) - 1, len(x)
    pw, ex = kernels.iir_powers(t), kernels.iir_exponents(t)

    def mv(j, v):  # P[j] 2^ex[j] @ (p, N) in the kernel's order
        m = pw[j]
        # the pads past the last chunk (block, tile) are scanned too: the
        # scan carries real entries into them, where a growing filter's
        # values overflow (inf - inf: NaN); no real entry reads a pad
        with np.errstate(invalid="ignore", over="ignore"):
            acc = m[:, :1] * v[:1]
            for c in range(1, p):
                acc = acc + m[:, c : c + 1] * v[c : c + 1]
        shift = min(int(ex[j]), kernels.IIR_EXP_CAP)
        while shift > 0:  # ldexpf: exact steps of at most 2^126
            k = min(shift, 126)
            acc, shift = acc * f(2.0 ** k), shift - k
        return acc

    def walk(xc, h, keep):
        ys = []
        for j in range(L):
            acc = t[0] * xc[:, j]
            for i in range(p, 1, -1):
                acc = acc + t[i] * h[i - 1]
            y = acc + t[1] * h[0]
            h = np.concatenate([y[None], h[:-1]])
            ys.append(y)
        return h, (np.stack(ys, 1) if keep else None)

    def block_scan(u, first):  # u: (p, rows, B), each row alone
        for j in range(7):
            d = 1 << j
            new = u.copy()
            for i in range(d, B):
                new[:, :, i] = u[:, :, i] + mv(first + j, u[:, :, i - d])
            u = new
        return u

    def bits(v, e, first, nbits):
        for j in range(nbits):
            if (e >> j) & 1:
                v = mv(first + j, v)
        return v

    k_n = -(-n // L)
    nb = -(-k_n // B)
    xc = np.zeros(k_n * L, f)
    xc[:n] = x
    xc = xc.reshape(k_n, L)
    h0 = np.zeros((p, k_n), f)
    h0[:, 0] = hist
    if k_n > 1:
        ends, _ = walk(xc, h0, False)
        u = np.zeros((p, nb * B), f)
        u[:, :k_n] = ends
        u = block_scan(u.reshape(p, nb, B), 0).reshape(p, nb * B)
        carry = np.zeros((p, nb), f)
        q = nb - 1
        tiles = -(-q // B)
        last = np.zeros((p, tiles * B), f)
        last[:, :q] = u[:, B - 1 :: B][:, :q]
        z = block_scan(last.reshape(p, tiles, B), 7)
        prev = None
        for tile in range(tiles):
            for i in range(B):
                if tile * B + i >= q:
                    break
                v = z[:, tile, i : i + 1]
                if prev is not None:
                    v = v + bits(prev, i + 1, 7, 8)
                carry[:, tile * B + i + 1] = v[:, 0]
            prev = carry[:, tile * B + B : tile * B + B + 1]
        for k in range(1, k_n):
            b, i = divmod(k, B)
            if b == 0:
                h0[:, k] = u[:, k - 1]
            elif i == 0:
                h0[:, k] = carry[:, b]
            else:
                h0[:, k] = u[:, k - 1] + bits(carry[:, b : b + 1], i, 0, 7)[:, 0]
    _, y = walk(xc, h0, True)
    return y.reshape(-1)[:n]


def iir_taps(order, rng):
    """The filters of IIR_TAPS, else a stable one: sum |taps[1:]| = 0.95."""
    if order in IIR_TAPS:
        return np.asarray(IIR_TAPS[order], np.float32)
    t = rng.uniform(-1, 1, order + 1)
    t[1:] *= 0.95 / np.abs(t[1:]).sum()
    return t.astype(np.float32)


@pytest.mark.parametrize("order", [1, 2, 8, 32])
def test_torch_iir_plain_version_is_the_kernels_order(order):
    # the first chunk is the sequential form bit for bit, and the whole
    # stream is the numpy restatement of the kernel's three passes
    rng = np.random.RandomState(order)
    taps = (np.asarray(IIR_TAPS[order], np.float32) if order in IIR_TAPS else
            np.concatenate([[1.0], 0.9 / order * rng.uniform(-1, 1, order)]
                           ).astype(np.float32))
    x = rng.randn(500).astype(np.float32)
    hist = rng.randn(order).astype(np.float32)
    got = kernels.iir_scan_plain(torch.from_numpy(x), taps, torch.from_numpy(hist))
    assert np.array_equal(got.numpy()[:L], iir_kernel_order(x[:L], taps, hist))
    assert np.array_equal(got.numpy(), iir_blocked_numpy(x, taps, hist))


def iir_f64_fast(x, taps, hist=None):
    """iir_f64 by scipy's lfilter (the history as its initial state)."""
    t = np.asarray(taps, np.float32).astype(np.float64)
    a = np.concatenate([[1.0], -t[1:]])
    zi = signal.lfiltic([t[0]], a, np.zeros(len(t) - 1) if hist is None
                        else np.asarray(hist, np.float64))
    return signal.lfilter([t[0]], a, np.asarray(x, np.float64), zi=zi)[0]


# n: one sample; a chunk less one, a chunk, a chunk and one; more chunks
# than one with a tail; 300 chunks (three blocks, no power of two); 2^16
IIR_NS = [1, L - 1, L, L + 1, 3 * L + 5, 300 * L - 17, 1 << 16]


@pytest.mark.parametrize("n", IIR_NS)
@pytest.mark.parametrize("order", [1, 2, 8, 16, 32])
@pytest.mark.parametrize("with_history", [False, True], ids=["zeros", "history"])
def test_torch_iir_plain_blocked_vs_float64_and_sequential(n, order, with_history):
    rng = np.random.RandomState(1000 * order + n % 997)
    taps = iir_taps(order, rng)
    x = rng.randn(n).astype(np.float32)
    hist = (rng.randn(order) if with_history else np.zeros(order)).astype(np.float32)
    y = kernels.iir_scan_plain(torch.from_numpy(x), taps,
                               torch.from_numpy(hist)).numpy()
    assert y.shape == (n,) and y.dtype == np.float32
    f = iir_f64_fast(x, taps, hist)
    assert rel(y, f, np.abs(f).max()) <= IIR_TOL
    head = min(n, L)
    seq = iir_kernel_order(x[:head], taps, hist)
    assert np.array_equal(y[:head], seq)
    if n <= 3 * L + 5:  # the whole stream sequentially too
        seq = iir_kernel_order(x, taps, hist)
        assert rel(y, seq, np.abs(f).max()) <= IIR_TOL


# the goldens' marginal filter (a pole at z = 1) and a pole pair just
# outside the unit circle: there the carries and the powers applied to
# them do not fade, so their order of operations shows in every output
MARGINAL = [1.0, 0.9, 0.1]
OUTSIDE = [1.0, 2 * 1.0002 * np.cos(0.3), -1.0002 ** 2]


@pytest.mark.parametrize("n", [3 * L + 5, 300 * L - 17])
@pytest.mark.parametrize("order", [1, 2, 8, 16, 32, "marginal", "outside"])
def test_torch_iir_plain_is_the_numpy_restatement(n, order):
    rng = np.random.RandomState(len(str(order)) + n)
    taps = (np.asarray(MARGINAL if order == "marginal" else OUTSIDE, np.float32)
            if isinstance(order, str) else iir_taps(order, rng))
    order = len(taps) - 1
    x = rng.randn(n).astype(np.float32)
    hist = rng.randn(order).astype(np.float32)
    got = kernels.iir_scan_plain(torch.from_numpy(x), taps, torch.from_numpy(hist))
    assert np.array_equal(got.numpy(), iir_blocked_numpy(x, taps, hist))


def test_torch_iir_plain_carry_tiles():
    # more blocks than one tile of the carries' scan (129 blocks and more:
    # n > B * B * L), at order 2: the numpy restatement bit for bit and
    # float64; and the marginal filter of the goldens (a pole at z = 1)
    # over as many chunks
    n = (B + 2) * B * L + 77  # 131 blocks: two tiles of carries
    rng = np.random.RandomState(11)
    x = rng.randn(n).astype(np.float32)
    for taps in (IIR_TAPS[2], MARGINAL):
        taps = np.asarray(taps, np.float32)
        hist = rng.randn(2).astype(np.float32)
        got = kernels.iir_scan_plain(torch.from_numpy(x), taps,
                                     torch.from_numpy(hist)).numpy()
        f = iir_f64_fast(x, taps, hist)
        assert rel(got, f, np.abs(f).max()) <= IIR_TOL
        assert np.array_equal(got, iir_blocked_numpy(x, taps, hist))


@pytest.mark.parametrize("n", [1 << 16, 300 * L - 17])
def test_torch_iir_plain_marginal_and_unstable_filters(n):
    # the goldens' marginal filter [1.0, 0.9, 0.1] (poles 1 and -0.1):
    # within IIR_TOL of float64.  A pole pair just outside the unit circle
    # (radius 1.0002: 5e5-fold growth over 2^16 samples), where f32
    # rounding grows with the signal in any order of summation (the
    # sequential form's error is 2e-5 - 3.4e-5 of max|y| here): finite
    # where the sequential form is, and no further from float64 than it
    rng = np.random.RandomState(n)
    x = rng.randn(n).astype(np.float32)
    for taps in (MARGINAL, OUTSIDE):
        taps = np.asarray(taps, np.float32)
        for hist in (np.zeros(2, np.float32), rng.randn(2).astype(np.float32)):
            got = kernels.iir_scan_plain(torch.from_numpy(x), taps,
                                         torch.from_numpy(hist)).numpy()
            seq = iir_kernel_order(x, taps, hist)
            f = iir_f64_fast(x, taps, hist)
            scale = np.abs(f).max()
            assert np.isfinite(seq).all() and np.isfinite(got).all()
            assert np.array_equal(got[:L], seq[:L])
            if taps[1] == np.float32(0.9):
                assert rel(got, f, scale) <= IIR_TOL
            else:
                assert rel(got, f, scale) <= rel(seq, f, scale)


def test_torch_iir_powers_are_the_companion_matrix_powers():
    # level j is A^(L 2^j) rounded once to f32, cached per taps
    taps = np.asarray(IIR_TAPS[2], np.float32)
    pw = kernels.iir_powers(taps)
    assert pw.shape == (kernels.IIR_LEVELS, 2, 2) and pw.dtype == np.float32
    assert kernels.iir_powers(taps.copy()) is pw
    a = np.array([[taps[1], taps[2]], [1.0, 0.0]], np.float64)
    for j in (0, 3):
        want = np.linalg.matrix_power(a, L << j)
        np.testing.assert_allclose(pw[j], want, rtol=1e-6, atol=1e-30)


def test_torch_recurrences_count_their_work():
    before = dict(kernels.WORK)
    ops.iir_filter(torch.zeros(100), IIR_TAPS[2])
    ops.cma_equalize(torch.zeros(100, dtype=torch.complex64), 4)
    want_b = kernels.iir_work(100, 2)[0] + kernels.cma_work(100, 4)[0]
    want_f = kernels.iir_work(100, 2)[1] + kernels.cma_work(100, 4)[1]
    assert kernels.WORK["bytes"] - before["bytes"] == want_b
    assert kernels.WORK["flops"] - before["flops"] == want_f


# Growing filters whose f32 powers M^(2^j) overflow: a pole at 1.001 (past
# f32's largest after ~88,700 samples from 1) and at 1 + 1/sqrt(2) (after
# ~170).  The port's powers carry a power-of-two exponent, so a zero state
# stays zero through any power and a tiny one stays finite wherever the
# true value is: JAX's sequential scan is the reference, float64 the
# arbiter.
GROWING_N = 1 << 18
SLOW_POLE = [1.0, 1.001]
FAST_POLES = [1.0, 2.0, -0.5]


def growing_stream(case):
    """(taps, x, history) of a growing-filter case over GROWING_N samples."""
    kind, taps = case.rsplit(" ", 1)
    taps = np.asarray(SLOW_POLE if taps == "slow" else FAST_POLES, np.float32)
    x = np.zeros(GROWING_N, np.float32)
    hist = np.zeros(len(taps) - 1, np.float32)
    if kind == "late impulse":
        x[-2000] = 1.0
    elif kind == "tiny impulse":
        x[0] = 1e-30
    elif kind == "tiny history":
        hist[0] = 1e-30
    return taps, x, hist


def first_non_finite(y):
    bad = np.flatnonzero(~np.isfinite(y))
    return int(bad[0]) if len(bad) else None


def worst_rel(y, f, upto):
    """max |y - f| / |f| over the first ``upto`` samples where f != 0."""
    y, f = y[:upto].astype(np.float64), f[:upto]
    live = f != 0
    return float((np.abs(y - f)[live] / np.abs(f[live])).max()) if live.any() else 0.0


@pytest.mark.parametrize("case", ["zeros slow", "zeros fast", "late impulse slow",
                                  "late impulse fast", "tiny impulse slow",
                                  "tiny history slow"])
def test_torch_iir_growing_filters_finite_where_jax_is(case):
    # measured on a CPU (n = 2^18): the zero streams 0 everywhere in both;
    # the late impulse through the slow pole ends at 7.374987 (JAX
    # 7.374980, float64 7.3749896), largest error against float64 7.1e-7
    # (JAX 1.3e-6), through the fast poles both overflow at 260,310; the
    # tiny impulse (history) overflows at 157,872 (157,871) in both, the
    # port's error 1.5e-6 beside JAX's 2.1e-5
    taps, x, hist = growing_stream(case)
    y = ops.iir_filter(x, taps, hist, device=CPU).numpy()
    jy = np.asarray(jops.iir_filter(x, taps, hist))
    with np.errstate(over="ignore", invalid="ignore"):
        f = iir_f64_fast(x, taps, hist)
    if case.startswith("zeros"):
        assert not y.any() and not jy.any()
        return
    jb, pb = first_non_finite(jy), first_non_finite(y)
    assert (jb is None) == (pb is None), (jb, pb)
    if jb is not None:
        assert abs(pb - jb) <= 4, (pb, jb)
    upto = min(v for v in (jb, pb, GROWING_N) if v is not None)
    assert worst_rel(y, f, upto) <= 2 * worst_rel(jy, f, upto)
    if case == "late impulse slow":
        assert np.isfinite(y[-1]) and abs(y[-1] - 7.375) < 1e-3
        assert abs(y[-1] - f[-1]) <= 2 * abs(jy[-1] - f[-1])


def old_powers(taps):
    """The powers as they were before they carried an exponent: A^(L 2^j)
    squared in float64, each level rounded once to f32."""
    t = np.asarray(taps, np.float32).astype(np.float64)
    p = len(t) - 1
    a = np.zeros((p, p))
    a[0] = t[1:]
    a[np.arange(1, p), np.arange(p - 1)] = 1.0
    out = []
    with np.errstate(over="ignore", invalid="ignore"):
        for _ in range(L.bit_length() - 1):
            a = a @ a
        for _ in range(kernels.IIR_LEVELS):
            out.append(a.astype(np.float32))
            a = a @ a
    return np.stack(out)


def _phase14_taps(monkeypatch):
    """chip_smoke.py's phase 14 filters."""
    import importlib.util
    import sys
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    monkeypatch.setitem(sys.modules, "chip_smoke", mod)  # for its dataclasses
    spec.loader.exec_module(mod)
    return [np.asarray(t, np.float32) for t in mod.IIR_TAPS.values()]


def test_torch_iir_powers_of_stable_filters_are_unchanged(monkeypatch):
    # every filter whose f32 powers are finite keeps its levels bit for bit
    # and every exponent 0: IIR_TAPS, phase 14's taps, the marginal filter
    # and the stable filters of the tests at orders 16 and 32
    rng = np.random.RandomState(3)
    filters = ([np.asarray(t, np.float32) for o, t in IIR_TAPS.items() if o]
               + _phase14_taps(monkeypatch) + [np.asarray(MARGINAL, np.float32)]
               + [iir_taps(o, rng) for o in (16, 32)])
    for taps in filters:
        assert np.array_equal(kernels.iir_powers(taps), old_powers(taps)), taps
        assert not kernels.iir_exponents(taps).any(), taps


@pytest.mark.parametrize("taps", [SLOW_POLE, FAST_POLES, OUTSIDE], ids=str)
def test_torch_iir_powers_of_growing_filters_carry_an_exponent(taps):
    # level j * 2^e_j is A^(L 2^j): its largest entry's log2 against the
    # dominant pole's; e_j = 0 where the level is a finite f32 as it was,
    # else the least that keeps the level finite
    taps = np.asarray(taps, np.float32)
    pw, ex = kernels.iir_powers(taps), kernels.iir_exponents(taps)
    old = old_powers(taps)
    assert pw.dtype == np.float32 and ex.dtype == np.int32 and np.isfinite(pw).all()
    pole = np.abs(np.roots(np.concatenate([[1.0], -taps[1:].astype(np.float64)]))).max()
    for j in range(kernels.IIR_LEVELS):
        if np.isfinite(old[j]).all():
            assert ex[j] == 0 and np.array_equal(pw[j], old[j]), j
            continue
        top = np.abs(pw[j]).max()
        assert ex[j] > 0 and top >= 2.0 ** 126, (j, ex[j], top)
        log2 = np.log2(top) + ex[j]
        assert abs(log2 - (L << j) * np.log2(pole)) <= 2 + 1e-6 * log2, j


@pytest.mark.parametrize("case", ["tiny impulse slow", "late impulse fast"])
def test_torch_iir_plain_is_the_numpy_restatement_on_growing_filters(case):
    # the powers' exponents in the plain version's products: bit for bit
    # the numpy restatement over three blocks, non-finite samples included
    taps, x, hist = growing_stream(case)
    n = 300 * L - 17
    x = x[-n:].copy() if case.startswith("late") else x[:n]
    got = kernels.iir_scan_plain(torch.from_numpy(x), taps,
                                 torch.from_numpy(hist)).numpy()
    with np.errstate(over="ignore", invalid="ignore"):  # past f32's largest
        want = iir_blocked_numpy(x, taps, hist)
    assert np.array_equal(np.isnan(got), np.isnan(want))
    assert np.array_equal(np.nan_to_num(got), np.nan_to_num(want))
