"""G3RUH-style LFSR scrambling (port of ``rustradio_tpu/ops/scramble.py``;
reference src/descrambler.rs).

Descrambling is feed-forward: with mask bits {j} and register length L,

    out[n] = x[n] ^ XOR_{j in mask} x[n - (L - j) - 1]

a windowed XOR over the input and its carried history, on the input's
device.

Scrambling is a feedback recurrence, linear over GF(2), so a block of B
bits is the affine map out = C s + T x, s_B = A^B s + U x of the current
register s (the JAX package's module docstring derives C, T, M = A^B and
U).  Here the two block products are 0/1 matrix products on the input's
device, exact in f32 (every product is 0 or 1 and a sum of at most B ones
is an exact integer, with or without TF32), and the short chain of
register states between blocks (one (L+1)-bit step a block) runs on the
host.  Inputs shorter than two blocks, and the tail, take the per-bit
register on the host: the reference semantics, bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import kernels


def _mask_delays(mask: int, length: int) -> list[int]:
    """Delays d such that out[n] ^= x[n-d]: d = L - j + 1 per mask bit j."""
    return [length - j + 1 for j in range(64) if (mask >> j) & 1]


def descramble(x, mask: int = 0x21, length: int = 16, history=None):
    """Feed-forward LFSR descramble; matches reference next_descramble
    (src/descrambler.rs:33-38) with seed 0, on ``x``'s device.

    ``history``: the previous length+1 input bits (for streaming), oldest
    first; defaults to zeros (== seed 0).
    """
    x = torch.as_tensor(x).to(torch.uint8)
    h = length + 1
    if history is None:
        hist = x.new_zeros(h)
    else:
        hist = torch.as_tensor(history).to(x.device, torch.uint8)
    xp = torch.cat([hist, x])
    n = x.shape[0]
    out = x
    for d in _mask_delays(mask, length):
        out = out ^ xp[h - d : h - d + n]
    return out


def _register(bits) -> int:
    """Register bits (bit j = s[j]) as a Python int."""
    return sum(int(b) << j for j, b in enumerate(bits))


def _scramble_bits(x: np.ndarray, reg: int, mask: int, length: int):
    """The per-bit register (reference next_scramble): emit s[0], shift in
    parity(s & mask) ^ x.  Returns (out, final register)."""
    out = np.empty(len(x), np.uint8)
    for i, xi in enumerate(x.tolist()):
        out[i] = reg & 1
        tmp = (bin(reg & mask).count("1") & 1) ^ xi
        reg = (reg >> 1) | (tmp << length)
    return out, reg


@functools.lru_cache(maxsize=8)
def _scramble_mats(mask: int, length: int, block: int):
    """GF(2) block matrices (C, T, M, U) for a B-bit scrambler step (a copy
    of the JAX package's numpy construction), cached per (mask, L, B)."""
    L1 = length + 1
    A = np.zeros((L1, L1), np.uint8)
    for j in range(length):
        A[j, j + 1] = 1  # s'[j] = s[j+1]
    A[length] = [(mask >> j) & 1 for j in range(L1)]  # s'[L] = m.s (+ x)
    B = block
    pows = [np.eye(L1, dtype=np.uint8)]
    for _ in range(B):
        pows.append((pows[-1] @ A) % 2)
    C = np.stack([p[0] for p in pows[:B]])          # (B, L1): c A^i
    w = np.array([p[0, length] for p in pows], np.uint8)  # c A^d e_L
    i, j = np.ogrid[:B, :B]
    d = i - 1 - j
    T = np.where(d >= 0, w[np.clip(d, 0, B)], 0).astype(np.uint8)  # (B, B)
    M = pows[B]                                      # (L1, L1): A^B
    U = np.stack([pows[B - 1 - jj][:, length] for jj in range(B)], axis=1)
    return C, T, M, U


def _scramble_blocked(x: torch.Tensor, s0: np.ndarray, mask: int,
                      length: int, block: int):
    """x of length nb*block -> (out, final register bits), identical to the
    per-bit register."""
    C, T, M, U = _scramble_mats(mask, length, block)
    dev = x.device
    nb = x.shape[0] // block
    X = x.reshape(nb, block).to(torch.float32)
    with kernels._true_f32():
        # per-block state injections V[k] = U x_k (mod 2)
        V = (X @ torch.from_numpy(U.T.astype(np.float32)).to(dev))
    V = V.to(torch.int64).cpu().numpy() & 1
    # the register before each block, s_{k+1} = M s_k + V[k] (mod 2)
    S = np.empty((nb, length + 1), np.int64)
    s = s0.astype(np.int64)
    Mi = M.astype(np.int64)
    for k in range(nb):
        S[k] = s
        s = (Mi @ s + V[k]) & 1
    with kernels._true_f32():
        out = X @ torch.from_numpy(T.T.astype(np.float32)).to(dev)
        out = out + (torch.from_numpy(S.astype(np.float32)).to(dev)
                     @ torch.from_numpy(C.T.astype(np.float32)).to(dev))
    out = (out.to(torch.int64) & 1).to(torch.uint8)
    return out.reshape(-1), s.astype(np.uint8)


def scramble(x, mask: int = 0x21, length: int = 16, seed: int = 0, state=None,
             block: int | None = 512):
    """LFSR scramble (reference next_scramble, src/descrambler.rs:39-45) on
    ``x``'s device.

    Returns (out, final_state), the state being the length+1 register bits
    as a uint8 tensor.  Inputs of two blocks or more run the GF(2) block
    form (see the module docstring) and the tail the per-bit register, bit
    for bit the same; ``block=None`` runs the per-bit register throughout.
    """
    x = torch.as_tensor(x).to(torch.uint8)
    if state is None:
        s0 = np.asarray([(seed >> j) & 1 for j in range(length + 1)], np.uint8)
    else:
        s0 = torch.as_tensor(state).cpu().numpy().astype(np.uint8)
    n = x.shape[0]
    dev = x.device
    head = x[:0]
    if block and n >= 2 * block:
        nb = n // block
        head, s0 = _scramble_blocked(x[: nb * block], s0, mask, length, block)
        x = x[nb * block :]
    tail, reg = _scramble_bits(x.cpu().numpy(), _register(s0), mask, length)
    out = torch.cat([head, torch.from_numpy(tail).to(dev)])
    fin = np.asarray([(reg >> j) & 1 for j in range(length + 1)], np.uint8)
    return out, torch.from_numpy(fin).to(dev)


def descramble_numpy(x: np.ndarray, mask: int = 0x21, length: int = 16) -> np.ndarray:
    """Host golden model: literal port of the reference LFSR semantics."""
    shift_reg = 0
    out = np.empty_like(x)
    for n, i in enumerate(x):
        ret = (bin(shift_reg & mask).count("1") & 1) ^ int(i)
        shift_reg = (shift_reg >> 1) | (int(i) << length)
        out[n] = ret
    return out
