"""8-bit pseudo-random / low-discrepancy sequence generators for DS-CIM.

The paper (Sec. IV-C) searches "mainstream 8-bit PRNGs" and initial seeds to
minimize the RMSE of the OR-MAC.  Everything here is a *deterministic*
host-side generator returning ``np.uint8`` arrays of length L; the chosen
sequence pair (PRNGA, PRNGW) is baked into the macro as constants (exactly
like the hardware, where the PRNG wiring is fixed at tape-out and the seed is
a register).

Hardware-faithful generators: LFSR (Fibonacci + Galois, several taps), LCG,
Weyl adder, xorshift.  Beyond-paper low-discrepancy generators (our accuracy
hillclimb): van-der-Corput, 2D Sobol (0,2)-sequence, R2/Kronecker.
"""
from __future__ import annotations

import numpy as np

__all__ = [
    "lfsr8", "galois_lfsr8", "lcg8", "weyl8", "xorshift8", "counter8",
    "vdc8", "sobol2d_8", "r2_8", "make_points", "PAIR_KINDS",
]

# ---------------------------------------------------------------------------
# scalar-recurrence PRNGs (hardware-typical)
# ---------------------------------------------------------------------------

# maximal-period 8-bit Fibonacci LFSR tap masks (period 255)
FIB_TAPS = (0xB8, 0xE1, 0xD4, 0xC6, 0x8E, 0x95, 0xAF, 0xB1)
# maximal-period Galois LFSR feedback polynomials
GAL_TAPS = (0x1D, 0x2B, 0x2D, 0x4D, 0x5F, 0x63, 0x65, 0x69)


def lfsr8(length: int, seed: int = 1, taps: int = 0xB8) -> np.ndarray:
    """Fibonacci LFSR over GF(2^8); emits the full 8-bit state per cycle."""
    state = np.uint8(seed if seed % 256 != 0 else 1)
    out = np.empty(length, np.uint8)
    for t in range(length):
        out[t] = state
        fb = bin(int(state) & taps).count("1") & 1
        state = np.uint8(((int(state) << 1) | fb) & 0xFF)
    return out


def galois_lfsr8(length: int, seed: int = 1, taps: int = 0x1D) -> np.ndarray:
    state = int(seed) % 256 or 1
    out = np.empty(length, np.uint8)
    for t in range(length):
        out[t] = state
        msb = state >> 7
        state = ((state << 1) & 0xFF) ^ (taps if msb else 0)
    return out


def lcg8(length: int, seed: int = 1, a: int = 141, c: int = 3) -> np.ndarray:
    """Full-period 8-bit LCG (a ≡ 1 mod 4, c odd)."""
    state = int(seed) % 256
    out = np.empty(length, np.uint8)
    for t in range(length):
        out[t] = state
        state = (a * state + c) % 256
    return out


def weyl8(length: int, seed: int = 0, alpha: int = 159) -> np.ndarray:
    """Additive Weyl sequence (x0 + t*alpha) mod 256; alpha odd => period 256.

    alpha = 159 ~ 256*(golden ratio - 1): a 1D low-discrepancy lattice.
    """
    t = np.arange(length, dtype=np.int64)
    return ((int(seed) + t * int(alpha)) % 256).astype(np.uint8)


def xorshift8(length: int, seed: int = 1, shifts=(3, 5, 4)) -> np.ndarray:
    s1, s2, s3 = shifts
    state = int(seed) % 256 or 1
    out = np.empty(length, np.uint8)
    for t in range(length):
        out[t] = state
        state ^= (state << s1) & 0xFF
        state ^= state >> s2
        state ^= (state << s3) & 0xFF
        state &= 0xFF
        if state == 0:
            state = 1
    return out


def counter8(length: int, seed: int = 0) -> np.ndarray:
    t = np.arange(length, dtype=np.int64)
    return ((int(seed) + t) % 256).astype(np.uint8)


# ---------------------------------------------------------------------------
# low-discrepancy sequences (beyond-paper accuracy option)
# ---------------------------------------------------------------------------

def _bitrev8(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint16)
    r = np.zeros_like(x)
    for i in range(8):
        r |= ((x >> i) & 1) << (7 - i)
    return r.astype(np.uint8)


def vdc8(length: int, seed: int = 0) -> np.ndarray:
    """van der Corput base 2, scaled to 8 bits, XOR-scrambled by ``seed``."""
    t = np.arange(length, dtype=np.uint16) % 256
    return (_bitrev8(t) ^ np.uint8(seed % 256)).astype(np.uint8)


# Sobol direction numbers for dimension 2 (primitive poly x^2 + x + 1, m1=1).
def _sobol_dim2_directions(bits: int = 8) -> np.ndarray:
    m = [1, 3]  # m_k (odd), standard Joe-Kuo initialisation for dim 2
    a = 1       # poly coefficient bits for x^2+x+1 (excluding leading/trailing)
    s = 2
    for k in range(s, bits):
        new = m[k - s] ^ (m[k - s] << s)
        for i in range(1, s):
            if (a >> (s - 1 - i)) & 1:
                new ^= m[k - i] << i
        m.append(new)
    # v_k = m_k * 2^(bits-k-1)
    return np.array([m[k] << (bits - k - 1) for k in range(bits)], np.uint16)


_SOBOL_V2 = _sobol_dim2_directions(8)


def sobol2d_8(length: int, seed_u: int = 0, seed_v: int = 0):
    """2D Sobol (0,2)-sequence scaled to [0,256)²; XOR digit-scrambled.

    Property: any elementary dyadic box of area 2^-ceil(log2 L) contains the
    expected number of points — per-block stratification is near-perfect for
    the DS-CIM 2^k×2^k partition.
    """
    t = np.arange(length, dtype=np.uint32)
    # dim 1: bit-reversed counter
    u = _bitrev8((t % 256).astype(np.uint16))
    # dim 2: Sobol via gray-code XOR of direction numbers
    v = np.zeros(length, np.uint16)
    gray = t ^ (t >> 1)
    for k in range(8):
        v ^= np.where((gray >> k) & 1, _SOBOL_V2[k], 0).astype(np.uint16)
    return (u ^ np.uint8(seed_u % 256)).astype(np.uint8), (
        (v & 0xFF).astype(np.uint8) ^ np.uint8(seed_v % 256)
    )


def r2_8(length: int, seed: int = 0):
    """R2 Kronecker sequence (plastic constant), 2D, scaled to 8 bits."""
    g = 1.32471795724474602596  # plastic number
    a1, a2 = 1.0 / g, 1.0 / (g * g)
    t = np.arange(length, dtype=np.float64) + 1 + seed
    u = np.floor((t * a1 % 1.0) * 256).astype(np.uint8)
    v = np.floor((t * a2 % 1.0) * 256).astype(np.uint8)
    return u, v


# ---------------------------------------------------------------------------
# paired-point factory
# ---------------------------------------------------------------------------

PAIR_KINDS = (
    "lfsr", "galois", "lcg", "weyl", "xorshift", "vdc", "sobol", "r2",
    "lfsr_weyl", "counter_vdc",
)


def make_points(kind: str, length: int, seed_u: int = 1, seed_v: int = 7,
                param_u: int | None = None, param_v: int | None = None):
    """Return (u, v) uint8 arrays of ``length`` sampling coordinates.

    ``param_*`` select taps/multipliers where applicable; defaults differ per
    axis so (u,v) are decorrelated even for equal seeds.
    """
    if kind == "lfsr":
        return (lfsr8(length, seed_u, FIB_TAPS[(param_u or 0) % len(FIB_TAPS)]),
                lfsr8(length, seed_v, FIB_TAPS[(param_v or 1) % len(FIB_TAPS)]))
    if kind == "galois":
        return (galois_lfsr8(length, seed_u, GAL_TAPS[(param_u or 0) % len(GAL_TAPS)]),
                galois_lfsr8(length, seed_v, GAL_TAPS[(param_v or 1) % len(GAL_TAPS)]))
    if kind == "lcg":
        return (lcg8(length, seed_u, a=141, c=3),
                lcg8(length, seed_v, a=205, c=57))
    if kind == "weyl":
        return (weyl8(length, seed_u, alpha=param_u or 159),
                weyl8(length, seed_v, alpha=param_v or 97))
    if kind == "xorshift":
        return (xorshift8(length, seed_u, (3, 5, 4)),
                xorshift8(length, seed_v, (5, 3, 1)))
    if kind == "vdc":
        return vdc8(length, seed_u), vdc8(length, seed_v ^ 0xA5)
    if kind == "sobol":
        return sobol2d_8(length, seed_u, seed_v)
    if kind == "r2":
        return r2_8(length, seed_u)
    if kind == "lfsr_weyl":
        return lfsr8(length, seed_u, 0xB8), weyl8(length, seed_v, alpha=159)
    if kind == "counter_vdc":
        return counter8(length, seed_u), vdc8(length, seed_v)
    raise ValueError(f"unknown point kind {kind!r}; one of {PAIR_KINDS}")
