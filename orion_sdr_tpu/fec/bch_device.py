"""Batched binary-BCH decode as ONE device program (outer code on the device).

The host/native decoder (galois.py / native/orion_native.cpp) is sequential
per codeword; this is the same algebra restructured for batched arrays:

* syndromes — S_j = Σ_p bit_p·α^{j·deg(p)} is GF(2)-bilinear, so all 8·t
  syndrome BITS of every codeword come from one int32 matmul mod 2
  (``bits @ T``);
* Berlekamp–Massey — 2t fixed iterations, vectorized over the batch with
  branchless per-codeword selects; the classic x^m shift register is kept
  pre-multiplied (b ← b·x each step, b ← (σ_old/δ)·x on reset) so no
  per-codeword dynamic shifts exist. GF division uses the table-free
  Fermat inverse a⁻¹ = a²⁵⁴ (13 multiplies), and GF multiplication itself
  is branchless carryless-multiply + 0x11D reduction over int32 lanes;
* Chien — σ(α^{-d}) over the valid degree window for ALL codewords at
  once: GF-multiply σ's coefficient columns with a precomputed α^{-m·d}
  plane and XOR-reduce;
* residual — the syndrome matmul again on the corrected words.

Behavior matches ``galois.Bch.decode_batch`` (systematic-prefix fallback on
failure; same accept set — uncorrectable words fail the root count or the
residual). The frame chain's outer decode uses it on a GPU for batches of
at least ``frame.chain._DEVICE_OUTER_MIN_BLOCKS`` codewords.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import jax
import jax.numpy as jnp

from .galois import GF_EXP
from ..dsp.device import cjit


def gf_mul(a, b):
    """Branchless GF(2^8) multiply over int32 arrays (poly 0x11D):
    carryless multiply then polynomial reduction — no tables, no gathers,
    and no selects (mask-multiplies keep the Mosaic/XLA graphs lean)."""
    a = jnp.asarray(a, jnp.int32)
    b = jnp.asarray(b, jnp.int32)
    res = jnp.zeros(jnp.broadcast_shapes(a.shape, b.shape), jnp.int32)
    for i in range(8):
        res = res ^ (((b >> i) & 1) * (a << i))
    for i in range(14, 7, -1):
        res = res ^ (((res >> i) & 1) * (0x11D << (i - 8)))
    return res


def gf_inv(a):
    """a⁻¹ = a²⁵⁴ (Fermat) — 254 = 2+4+8+16+32+64+128."""
    sq = gf_mul(a, a)            # a^2
    acc = sq
    p = sq
    for _ in range(6):           # a^4 … a^128
        p = gf_mul(p, p)
        acc = gf_mul(acc, p)
    return acc                   # zero maps to zero (0^n = 0)


@lru_cache(maxsize=16)
def _tables(n: int, t: int):
    """Syndrome bit-matrix T (n, 2t·8) with S_j bit b at column j·8+b, and
    the Chien plane α^{-m·d} (cap, n) over the valid degree window."""
    shift = 255 - n
    deg = (n - 1 - np.arange(n)) + shift                       # (n,)
    js = np.arange(1, 2 * t + 1)
    alpha = GF_EXP[(js[:, None] * deg[None, :]) % 255]          # (2t, n)
    T = np.zeros((n, 2 * t * 8), np.int32)
    for j in range(2 * t):
        for b in range(8):
            T[:, j * 8 + b] = (alpha[j] >> b) & 1
    cap = t + 2
    d = shift + np.arange(n)                                    # window degs
    chien = GF_EXP[(-(np.arange(cap)[:, None]) * d[None, :]) % 255]
    return shift, T, chien.astype(np.int32)


# the unrolled BM/Ω graphs grow as O(t²·cap) gf_mul subgraphs: past t=8 the
# compile cost explodes, so the device paths serve the deployed code sizes
# (DVB RS t=8, frame BCH t<=8) and larger codes stay on the native host path
MAX_DEVICE_T = 8


@cjit
def bch_decode_batch_device(n: int, k: int, t: int, bits):
    """(B, n) bit codewords → ((B, k) message bits, (B,) ok int32 flags).

    One fused device program for the whole batch; failed rows hold the
    systematic prefix, matching the host decoders. Supports t <= 8
    (MAX_DEVICE_T); callers fall back to the native/numpy paths beyond.
    """
    assert t <= MAX_DEVICE_T, "device BCH supports t <= 8"
    shift, T, chien = _tables(n, t)
    cap = t + 2
    r = jnp.asarray(bits).astype(jnp.int32) & 1                 # (B, n)
    B = r.shape[0]

    def syndromes(word):
        # 0/1 operands are exact even as TF32, and the f32 accumulator
        # holds sums ≤ n < 2^24 exactly
        sb = jnp.matmul(word.astype(jnp.float32),
                        jnp.asarray(T, jnp.float32),
                        preferred_element_type=jnp.float32)
        sb = sb.astype(jnp.int32) & 1                           # (B, 2t·8)
        sb = sb.reshape(B, 2 * t, 8)
        weights = (1 << jnp.arange(8, dtype=jnp.int32))
        return jnp.sum(sb * weights, axis=-1)                   # (B, 2t) bytes

    s = syndromes(r)                                            # s[:, j-1] = S_j
    any_err = jnp.any(s != 0, axis=-1)                          # (B,)

    # ── Berlekamp–Massey (start=1), branchless over the batch ────────────────
    # s1[j] = S_j for j = 1..2t (index 0 unused → 0)
    s1 = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), s], axis=-1)
    sigma = jnp.zeros((B, cap), jnp.int32).at[:, 0].set(1)
    # bx = b·x^m kept pre-shifted: starts at x
    bx = jnp.zeros((B, cap), jnp.int32).at[:, 1].set(1)
    l = jnp.zeros((B,), jnp.int32)

    def shift1(p):
        return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), p[:, :-1]],
                               axis=-1)

    # fori_loop keeps the BM graph one-iteration-sized (the unrolled form
    # compiles far more slowly)
    iidx = jnp.arange(cap)

    def bm_body(nn, carry):
        sigma, bx, l = carry
        gather = jnp.take(s1, jnp.clip(nn - iidx, 0, 2 * t), axis=1)
        gather = jnp.where((nn - iidx >= 1)[None, :], gather, 0)
        prods = gf_mul(sigma, gather)
        delta = jax.lax.reduce(prods, np.int32(0), jax.lax.bitwise_xor, [1])
        t_new = sigma ^ gf_mul(delta[:, None], bx)
        reset = (delta != 0) & (2 * l < nn)
        new_bx_reset = shift1(gf_mul(gf_inv(delta)[:, None], sigma))
        sigma = jnp.where((delta != 0)[:, None], t_new, sigma)
        bx = jnp.where(reset[:, None], new_bx_reset, shift1(bx))
        l = jnp.where(reset, nn - l, l)
        return sigma, bx, l

    sigma, bx, l = jax.lax.fori_loop(1, 2 * t + 1, bm_body, (sigma, bx, l))

    # degree of σ (highest nonzero coefficient)
    nz = sigma != 0
    idx = jnp.arange(cap, dtype=jnp.int32)
    sdeg = jnp.max(jnp.where(nz, idx, 0), axis=-1)              # (B,)

    # ── Chien over the valid degree window ───────────────────────────────────
    # v[b, p] = σ(α^{-(shift+p)}) — zero ⇒ error at word position n-1-p… the
    # chien plane is indexed so column p corresponds to word position
    # n-1+shift-(shift+p) = n-1-p
    prods = gf_mul(sigma[:, :, None], jnp.asarray(chien)[None, :, :])
    v = prods[:, 0, :]
    for m in range(1, cap):
        v = v ^ prods[:, m, :]                                  # XOR over m
    roots = (v == 0)                                            # (B, n) by p
    flips = roots[:, ::-1].astype(jnp.int32)                    # word order
    n_found = jnp.sum(roots, axis=-1).astype(jnp.int32)

    corrected = r ^ flips
    s_res = syndromes(corrected)
    resid_ok = jnp.all(s_res == 0, axis=-1)

    del sdeg  # host BCH adjudicates via residual + count, not sigma degree
    ok_err = resid_ok & (n_found <= t)
    ok = jnp.where(any_err, ok_err, True)
    use_corr = any_err & ok_err
    out = jnp.where(use_corr[:, None], corrected[:, :k], r[:, :k])
    return out.astype(jnp.uint8), ok.astype(jnp.int32)


# ── Reed-Solomon, same machinery + Forney magnitudes ─────────────────────────


@lru_cache(maxsize=16)
def _rs_tables(n: int, n_parity: int):
    """RS syndrome bit-matrix (n·8, 2t·8): S_j = Σ_p r_p·α^{j·deg(p)} is
    GF(2)-bilinear in the BITS of r_p, plus the α^{±m·d} evaluation planes
    over the valid degree window (for σ, σ', Ω at x = α^{-d}) and the root
    locations x_d = α^{d}."""
    shift = 255 - n
    t = n_parity // 2
    cap = t + 2
    deg = (n - 1 - np.arange(n)) + shift
    js = np.arange(n_parity)
    alpha = GF_EXP[(js[:, None] * deg[None, :]) % 255]          # (2t, n)
    M = np.zeros((n * 8, n_parity * 8), np.int32)
    for j in range(n_parity):
        for c in range(8):
            # contribution of bit c of r_p to S_j: (2^c)·α^{j·deg(p)}
            from .galois import gf_mul as _gm
            contrib = _gm(np.full(n, 1 << c, np.uint8), alpha[j])
            for b in range(8):
                M[c::8, j * 8 + b] = (contrib >> b) & 1
    d = shift + np.arange(n)
    # x^{-m·d} planes for m = 0..max(cap, 2t)-1 (σ needs cap, Ω needs 2t)
    mmax = max(cap, n_parity)
    inv_plane = GF_EXP[(-(np.arange(mmax)[:, None]) * d[None, :]) % 255]
    x_d = GF_EXP[d % 255]                                       # α^{d}
    return shift, M, inv_plane.astype(np.int32), x_d.astype(np.int32)


@cjit
def rs_decode_batch_device(n: int, n_parity: int, received):
    """(B, n) byte codewords → ((B, k) messages, (B,) ok int32 flags); the
    whole batch decodes in ONE device program. Matches
    ``galois.ReedSolomon.decode_batch`` (systematic prefix on failure).
    Supports t <= 8 (MAX_DEVICE_T)."""
    assert n_parity // 2 <= MAX_DEVICE_T, "device RS supports t <= 8"
    shift, M, inv_plane, x_d = _rs_tables(n, n_parity)
    t = n_parity // 2
    cap = t + 2
    k = n - n_parity
    r = jnp.asarray(received).astype(jnp.int32) & 0xFF          # (B, n)
    B = r.shape[0]

    def syndromes(word):
        bits = ((word[:, :, None] >> jnp.arange(8, dtype=jnp.int32)) & 1
                ).reshape(B, n * 8)
        sb = jnp.matmul(bits.astype(jnp.float32),
                        jnp.asarray(M, jnp.float32),
                        preferred_element_type=jnp.float32)
        sb = sb.astype(jnp.int32) & 1
        sb = sb.reshape(B, n_parity, 8)
        weights = (1 << jnp.arange(8, dtype=jnp.int32))
        return jnp.sum(sb * weights, axis=-1)                   # (B, 2t)

    s = syndromes(r)                                            # S_0..S_{2t-1}
    any_err = jnp.any(s != 0, axis=-1)

    # ── BM (start=0) ─────────────────────────────────────────────────────────
    sigma = jnp.zeros((B, cap), jnp.int32).at[:, 0].set(1)
    bx = jnp.zeros((B, cap), jnp.int32).at[:, 1].set(1)
    l = jnp.zeros((B,), jnp.int32)

    def shift1(p):
        return jnp.concatenate([jnp.zeros((B, 1), jnp.int32), p[:, :-1]],
                               axis=-1)

    iidx = jnp.arange(cap)

    def bm_body(nn, carry):
        sigma, bx, l = carry
        gather = jnp.take(s, jnp.clip(nn - iidx, 0, n_parity - 1), axis=1)
        gather = jnp.where((nn - iidx >= 0)[None, :], gather, 0)
        prods = gf_mul(sigma, gather)
        delta = jax.lax.reduce(prods, np.int32(0), jax.lax.bitwise_xor, [1])
        t_new = sigma ^ gf_mul(delta[:, None], bx)
        reset = (delta != 0) & (2 * l <= nn)
        new_bx_reset = shift1(gf_mul(gf_inv(delta)[:, None], sigma))
        sigma = jnp.where((delta != 0)[:, None], t_new, sigma)
        bx = jnp.where(reset[:, None], new_bx_reset, shift1(bx))
        l = jnp.where(reset, nn + 1 - l, l)
        return sigma, bx, l

    sigma, bx, l = jax.lax.fori_loop(0, n_parity, bm_body, (sigma, bx, l))

    nz = sigma != 0
    idx = jnp.arange(cap, dtype=jnp.int32)
    sdeg = jnp.max(jnp.where(nz, idx, 0), axis=-1)

    # ── Ω = S·σ mod x^{2t} ───────────────────────────────────────────────────
    # Ω as a GF polynomial convolution: Σ_j shift_j(σ_j · S), j static-small
    omega = jnp.zeros((B, n_parity), jnp.int32)
    for j in range(cap):
        prod = gf_mul(sigma[:, j:j + 1], s)          # (B, 2t)
        if j:
            prod = jnp.concatenate(
                [jnp.zeros((B, j), jnp.int32), prod[:, :-j]], axis=1)
        omega = omega ^ prod
    # σ' = odd terms: deriv[m] = σ_{m+1} for even m
    deriv = jnp.zeros((B, cap), jnp.int32)
    for m in range(0, cap - 1, 2):
        deriv = deriv.at[:, m].set(sigma[:, m + 1])

    # ── evaluate σ, σ', Ω at x = α^{-d} over the window ─────────────────────
    plane = jnp.asarray(inv_plane)                              # (mmax, n)

    def poly_eval_all(coeffs, ncoef):
        prods = gf_mul(coeffs[:, :ncoef, None], plane[None, :ncoef, :])
        v = prods[:, 0, :]
        for m in range(1, ncoef):
            v = v ^ prods[:, m, :]
        return v                                                # (B, n)

    sig_v = poly_eval_all(sigma, cap)
    roots = (sig_v == 0)                                        # (B, n) by p
    n_err = jnp.sum(roots, axis=-1).astype(jnp.int32)

    om_v = poly_eval_all(omega, n_parity)
    dv_v = poly_eval_all(deriv, cap)
    # Forney: e_p = x·Ω(x⁻¹)/σ'(x⁻¹) at x = α^{d}
    mag = gf_mul(jnp.asarray(x_d)[None, :], gf_mul(om_v, gf_inv(dv_v)))
    bad_dv = jnp.any(roots & (dv_v == 0), axis=-1)
    flips = jnp.where(roots, mag, 0)[:, ::-1]                   # word order
    corrected = r ^ flips

    s_res = syndromes(corrected)
    resid_ok = jnp.all(s_res == 0, axis=-1)

    ok_err = (resid_ok & (~bad_dv) & (n_err == sdeg) & (sdeg <= t))
    ok = jnp.where(any_err, ok_err, True)
    use_corr = any_err & ok_err
    out = jnp.where(use_corr[:, None], corrected[:, :k], r[:, :k])
    return out.astype(jnp.uint8), ok.astype(jnp.int32)


# ── encode ───────────────────────────────────────────────────────────────────


@lru_cache(maxsize=16)
def _bch_parity_matrix(n: int, k: int, t: int) -> np.ndarray:
    """(k, parity) GF(2) matrix P with parity(m) = m·P mod 2.

    The systematic LFSR (ref fec/bch.rs encode; native bch_encode_batch)
    is linear over GF(2), so row i is the register a lone 1 fed at step i
    leaves after the remaining k−1−i zero-input steps — identical to the
    native encoder's R table, emitted in output bit order."""
    from .galois import _bch_generator
    gen = _bch_generator(t)                      # MSB-first, len parity+1
    parity = len(gen) - 1
    assert k + parity == n
    mask = 0
    for j in range(1, parity + 1):
        if gen[j]:
            mask |= 1 << (parity - j)
    pmask = (1 << parity) - 1
    top_bit = 1 << (parity - 1)
    R = [0] * k
    r = mask & pmask
    R[k - 1] = r
    for i in range(k - 2, -1, -1):
        fb = mask if (r & top_bit) else 0
        r = ((r << 1) ^ fb) & pmask
        R[i] = r
    P = np.zeros((k, parity), np.uint8)
    for i in range(k):
        for j in range(parity):
            P[i, j] = (R[i] >> (parity - 1 - j)) & 1
    return P


@cjit
def bch_encode_batch_device(n: int, k: int, t: int, message_bits):
    """(..., k) message bits → (..., n) systematic codewords on device.

    parity = message · P mod 2: ONE int matmul (the same
    formulation as ldpc_encode's A·msg), so batched TX encode runs at
    LDPC-encode-like rates instead of the host LFSR's. Bit-exact vs
    galois.Bch.encode / native bch_encode_batch."""
    P = jnp.asarray(_bch_parity_matrix(n, k, t).astype(np.int32))
    m = jnp.asarray(message_bits).astype(jnp.int32) & 1
    par = jnp.einsum("kp,...k->...p", P, m) & 1
    return jnp.concatenate([m, par], axis=-1).astype(jnp.uint8)


@lru_cache(maxsize=16)
def _rs_parity_bit_matrix(n: int, n_parity: int) -> np.ndarray:
    """(k·8, n_parity·8) GF(2) matrix P with parity_bits(m) = m_bits·P mod 2.

    GF(256) addition is XOR and multiplication by a constant is GF(2)-linear
    on the bit vector, so the whole systematic RS LFSR (ref
    fec/reed_solomon.rs encode; galois.Rs numpy path) is GF(2)-linear in the
    MESSAGE BITS. Rows are built empirically: encode the k·8 unit-bit
    messages through the numpy reference in one batch and unpack the parity
    bytes (np.unpackbits order, matching frame/chain.py's bytes_to_bits)."""
    from .galois import ReedSolomon
    rs = ReedSolomon(n, n_parity)
    k = rs.k
    unit = np.zeros((k * 8, k), np.uint8)
    rows = np.repeat(np.arange(k), 8)
    unit[np.arange(k * 8), rows] = 0x80 >> np.tile(np.arange(8), k)
    parity = np.asarray(rs.encode(unit))[:, k:]       # (k*8, n_parity) bytes
    return np.unpackbits(parity, axis=1)              # (k*8, n_parity*8)


@cjit
def rs_encode_batch_device(n: int, n_parity: int, message_bytes):
    """(..., k) message bytes → (..., n) systematic RS codewords on device.

    Same GF(2)-linearization as bch_encode_batch_device: unpack message
    bytes to bits, ONE int matmul against the cached parity bit-matrix,
    repack parity bits to bytes. Bit-exact vs galois.Rs.encode / native
    rs_encode_batch; keeps device-resident TX chains on the device."""
    k = n - n_parity
    P = jnp.asarray(_rs_parity_bit_matrix(n, n_parity).astype(np.int32))
    m = jnp.asarray(message_bytes).astype(jnp.int32) & 0xFF
    shifts = jnp.arange(7, -1, -1, jnp.int32)
    mbits = ((m[..., :, None] >> shifts) & 1).reshape(m.shape[:-1] + (k * 8,))
    pbits = jnp.einsum("bp,...b->...p", P, mbits) & 1
    pbits = pbits.reshape(m.shape[:-1] + (n_parity, 8))
    par = jnp.einsum("...pj,j->...p", pbits, (1 << shifts))
    return jnp.concatenate([m, par], axis=-1).astype(jnp.uint8)
