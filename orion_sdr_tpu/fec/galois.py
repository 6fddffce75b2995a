"""GF(2^8) arithmetic + binary BCH + Reed-Solomon.

Behavioral spec: /root/reference/src/fec/{gf,bch,reed_solomon}.rs.
Primitive polynomial 0x11D; RS first consecutive root FCR = 0 (generator
Π(x − α^i), i = 0..2t−1); BCH generator = lcm of minimal polynomials of
α^1..α^2t; shortened codes occupy the high end of the length-255 frame.

These are byte/bit-domain algebraic codes — low-rate control-path work, per
the build plan (SURVEY.md §7.7) implemented host-side in numpy with
vectorized syndrome/Chien evaluation (table gathers) and *batch-vectorized*
LFSR encoders (the per-step loop runs once, every codeword in the batch
advances together). The interface is pure so the hot cases can later move
to the device without API change (fec/bch_device.py).
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

_PRIM = 0x11D

# ── GF(2^8) tables ───────────────────────────────────────────────────────────


def _build_tables():
    exp = np.zeros(512, np.uint8)
    log = np.zeros(256, np.uint8)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= _PRIM
    exp[255:510] = exp[:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def gf_mul(a, b):
    """Vectorized GF(2^8) multiply (0-handling included)."""
    a = np.asarray(a, np.uint8)
    b = np.asarray(b, np.uint8)
    out = GF_EXP[GF_LOG[a].astype(np.int32) + GF_LOG[b].astype(np.int32)]
    return np.where((a == 0) | (b == 0), 0, out).astype(np.uint8)


def gf_inv(a):
    a = np.asarray(a, np.uint8)
    return GF_EXP[255 - GF_LOG[a].astype(np.int32)].astype(np.uint8)


def gf_pow_alpha(e):
    """α^e for integer exponents (array ok)."""
    return GF_EXP[np.asarray(e) % 255].astype(np.uint8)


def _poly_eval(p, x):
    """Horner over GF(2^8); p low-degree-first, scalars."""
    acc = np.uint8(0)
    for c in p[::-1]:
        acc = gf_mul(acc, x) ^ np.uint8(c)
    return acc


def _poly_mul(a, b):
    out = np.zeros(len(a) + len(b) - 1, np.uint8)
    for i, ai in enumerate(a):
        if ai:
            out[i:i + len(b)] ^= gf_mul(ai, b)
    return out


def _berlekamp_massey(s, t, start):
    """σ(x) low-degree-first from syndromes; ``start``=1 for BCH (s[1..2t]),
    0 for RS (s[0..2t−1]) — mirrors the two reference variants."""
    sigma = np.array([1], np.uint8)
    b = np.array([1], np.uint8)
    l, m = 0, 1
    rng = range(1, 2 * t + 1) if start == 1 else range(0, 2 * t)
    for n in rng:
        delta = int(s[n])
        for i in range(1, l + 1):
            if i < len(sigma):
                delta ^= int(gf_mul(sigma[i], s[n - i]))
        cond = (2 * l < n) if start == 1 else (2 * l <= n)
        if delta == 0:
            m += 1
        elif cond:
            t_sigma = sigma.copy()
            sigma = _apply_correction(sigma, b, delta, m)
            l = (n - l) if start == 1 else (n + 1 - l)
            b = gf_mul(t_sigma, gf_inv(np.uint8(delta)))
            m = 1
        else:
            sigma = _apply_correction(sigma, b, delta, m)
            m += 1
    return sigma


def _apply_correction(sigma, b, coef, shift):
    needed = len(b) + shift
    out = np.zeros(max(len(sigma), needed), np.uint8)
    out[:len(sigma)] = sigma
    out[shift:shift + len(b)] ^= gf_mul(np.uint8(coef), b)
    return out


# ── Reed-Solomon ─────────────────────────────────────────────────────────────


class RsError(ValueError):
    pass


@lru_cache(maxsize=None)
def _rs_generator(n_parity: int) -> tuple:
    g = np.array([1], np.uint8)
    for i in range(n_parity):
        g = _poly_mul(g, np.array([gf_pow_alpha(i), 1], np.uint8))
    return tuple(int(v) for v in g)


class ReedSolomon:
    """RS(n, k = n − n_parity) over GF(2^8), FCR=0 (ref: reed_solomon.rs:38-329).

    ``ReedSolomon.dvb()`` = RS(204,188), t=8 — DVB-T's outer code.
    """

    def __init__(self, n: int, n_parity: int):
        if n == 0 or n > 255 or n_parity >= n:
            raise RsError(f"bad RS({n}, parity {n_parity})")
        self.n, self.n_parity = n, n_parity
        self.k = n - n_parity
        self.gen = np.array(_rs_generator(n_parity), np.uint8)  # low-first
        shift = 255 - n
        deg = (n - 1 - np.arange(n)) + shift           # code degree per position
        js = np.arange(n_parity)
        # syndrome matrix: M[j, p] = α^(j·deg(p))
        self._synmat = GF_EXP[(js[:, None] * deg[None, :]) % 255].astype(np.uint8)
        self._deg = deg
        self._shift = shift

    @staticmethod
    def dvb() -> "ReedSolomon":
        return ReedSolomon(204, 16)

    @property
    def t(self) -> int:
        return self.n_parity // 2

    def encode(self, message) -> np.ndarray:
        """Batched systematic encode: (..., k) bytes → (..., n).

        2-D batches dispatch to the native table-LFSR encoder
        (native/orion_native.cpp::rs_encode_batch, bit-exact, ~5 Gbps/core
        vs this numpy LFSR's ~0.1); the numpy path remains the reference
        and the no-toolchain fallback."""
        msg_nd = np.asarray(message, np.uint8)
        if msg_nd.ndim == 2 and msg_nd.shape[0] >= 4:
            from .. import native
            out = native.rs_encode_batch(self.n, self.n_parity, msg_nd)                 if native.AVAILABLE else None
            if out is not None:
                return out
        msg = np.atleast_2d(msg_nd)
        B = msg.shape[0] if msg.ndim == 2 else 1
        reg = np.zeros(msg.shape[:-1] + (self.n_parity,), np.uint8)
        gen_hi = self.gen[:-1][::-1]  # gen coefficients for the shift update
        for i in range(self.k):
            fb = msg[..., i] ^ reg[..., 0]
            upd = gf_mul(fb[..., None], gen_hi[None, :])
            reg = np.concatenate([reg[..., 1:],
                                  np.zeros(reg.shape[:-1] + (1,), np.uint8)], axis=-1) ^ upd
        out = np.concatenate([msg, reg], axis=-1)
        return out if np.asarray(message).ndim > 1 else out[0]

    def _syndromes(self, word):
        prods = gf_mul(word[None, :], self._synmat)
        acc = np.zeros(self.n_parity, np.uint8)
        for p in range(self.n):
            acc ^= prods[:, p]
        return acc

    def decode(self, received) -> np.ndarray:
        """Correct ≤ t byte errors; raises RsError if uncorrectable."""
        r = np.asarray(received, np.uint8)
        assert r.shape[-1] == self.n
        if r.ndim > 1:
            return np.stack([self.decode(row) for row in r])
        s = self._syndromes(r)
        if not s.any():
            return r[:self.k].copy()
        sigma = _berlekamp_massey(s, self.t, start=0)
        # Chien: σ(α^{-i}) == 0 → error at code degree i
        i_all = np.arange(255)
        xinv = GF_EXP[(255 - i_all % 255) % 255]
        vals = np.zeros(255, np.uint8)
        xp = np.ones(255, np.uint8)
        for c in sigma:
            vals ^= gf_mul(np.uint8(c), xp)
            xp = gf_mul(xp, xinv)
        err_deg = np.nonzero(vals == 0)[0]
        sigma_deg = int(np.nonzero(sigma)[0].max()) if sigma.any() else 0
        if len(err_deg) != sigma_deg or sigma_deg > self.t:
            raise RsError(f"uncorrectable ({sigma_deg})")
        # Forney
        omega = np.zeros(self.n_parity, np.uint8)
        for i, si in enumerate(s):
            if si:
                for j, sj in enumerate(sigma):
                    if sj and i + j < self.n_parity:
                        omega[i + j] ^= gf_mul(np.uint8(si), np.uint8(sj))
        deriv = np.zeros(max(len(sigma) - 1, 1), np.uint8)
        for kk in range(1, len(sigma), 2):
            deriv[kk - 1] = sigma[kk]
        corrected = r.copy()
        for i in err_deg:
            x = GF_EXP[i % 255]
            x_inv = gf_inv(np.uint8(x))
            ov = _poly_eval(omega, x_inv)
            dv = _poly_eval(deriv, x_inv)
            if dv == 0:
                raise RsError("uncorrectable (zero derivative)")
            mag = gf_mul(np.uint8(x), gf_mul(ov, gf_inv(dv)))
            if self._shift <= i <= self.n - 1 + self._shift:
                p = self.n - 1 + self._shift - i
                corrected[p] ^= mag
        if self._syndromes(corrected).any():
            raise RsError("uncorrectable (residual)")
        return corrected[:self.k].copy()

    def decode_batch(self, received):
        """(B, n) → ((B, k), ok flags); failed rows hold the systematic
        prefix. Uses the native C++ batch decoder when available."""
        r = np.asarray(received, np.uint8)
        from .. import native
        if native.AVAILABLE:
            res = native.rs_decode_batch(self.n, self.n_parity, r)
            if res is not None:
                return res
        out = np.empty((r.shape[0], self.k), np.uint8)
        ok = np.ones(r.shape[0], bool)
        for i, row in enumerate(r):
            try:
                out[i] = self.decode(row)
            except RsError:
                out[i] = row[:self.k]
                ok[i] = False
        return out, ok


# ── Binary BCH over GF(2^8) ──────────────────────────────────────────────────


class BchError(ValueError):
    pass


@lru_cache(maxsize=None)
def _bch_generator(t: int) -> tuple:
    """g(x) = lcm of minimal polys of α^1..α^2t, returned MSB-first GF(2)."""
    g = np.array([1], np.uint8)  # low-degree-first
    used = set()
    for j in range(1, 2 * t + 1):
        # cyclotomic coset of j mod 255
        coset = []
        r = j
        while r not in coset:
            coset.append(r)
            r = (r * 2) % 255
        key = min(coset)
        if key in used:
            continue
        used.add(key)
        minp = np.array([1], np.uint8)
        for r in coset:
            minp = _poly_mul(minp, np.array([GF_EXP[r], 1], np.uint8))
        # a complete conjugate coset gives GF(2) coefficients (0/1) by construction
        g = _poly_mul(g, minp)
    if len(g) - 1 >= 255:
        raise BchError(f"t={t} too large")
    # low-first GF(2) → MSB-first bit vector
    return tuple(int(v & 1) for v in g[::-1])


class Bch:
    """Binary BCH(n, k, t), optionally shortened (ref: bch.rs:43-369)."""

    def __init__(self, t: int, n: int = 255):
        gen = np.array(_bch_generator(t), np.uint8)  # MSB-first
        parity = len(gen) - 1
        if n == 0 or n > 255 or parity >= n:
            raise BchError(f"bad n={n}")
        self.n, self.t = n, t
        self.k = n - parity
        self.gen = gen
        self._shift = 255 - n
        deg = (n - 1 - np.arange(n)) + self._shift
        js = np.arange(1, 2 * t + 1)
        self._synmat = GF_EXP[(js[:, None] * deg[None, :]) % 255].astype(np.uint8)

    @property
    def parity_bits(self) -> int:
        return len(self.gen) - 1

    def encode(self, message) -> np.ndarray:
        """Batched systematic encode: (..., k) bits → (..., n) bits.

        2-D batches dispatch to the native uint64-register LFSR
        (native/orion_native.cpp::bch_encode_batch, bit-exact); numpy is
        the reference and fallback."""
        msg_nd = np.asarray(message, np.uint8) & 1
        if msg_nd.ndim == 2 and msg_nd.shape[0] >= 4:
            from .. import native
            out = native.bch_encode_batch(self.n, self.k, self.t, msg_nd)                 if native.AVAILABLE else None
            if out is not None:
                return out
        msg = msg_nd
        pb = self.parity_bits
        reg = np.zeros(msg.shape[:-1] + (pb,), np.uint8)
        gtail = self.gen[1:]  # gen[1..] per the reference LFSR
        for i in range(self.k):
            fb = (msg[..., i] ^ reg[..., 0])[..., None]
            shifted = np.concatenate([reg[..., 1:],
                                      np.zeros(reg.shape[:-1] + (1,), np.uint8)], axis=-1)
            reg = shifted ^ (gtail * fb)
        return np.concatenate([msg, reg], axis=-1)

    def _syndromes(self, bits):
        mask = bits.astype(bool)
        acc = np.zeros(2 * self.t, np.uint8)
        cols = self._synmat[:, mask]
        for c in range(cols.shape[1]):
            acc ^= cols[:, c]
        return acc

    def decode(self, received) -> np.ndarray:
        """Correct ≤ t bit errors; raises BchError if uncorrectable."""
        r = np.asarray(received, np.uint8) & 1
        assert r.shape[-1] == self.n
        if r.ndim > 1:
            return np.stack([self.decode(row) for row in r])
        s = np.concatenate([[0], self._syndromes(r)]).astype(np.uint8)
        if not s[1:].any():
            return r[:self.k].copy()
        sigma = _berlekamp_massey(s, self.t, start=1)
        i_all = np.arange(255)
        xinv = GF_EXP[(255 - i_all % 255) % 255]
        vals = np.zeros(255, np.uint8)
        xp = np.ones(255, np.uint8)
        for c in sigma:
            vals ^= gf_mul(np.uint8(c), xp)
            xp = gf_mul(xp, xinv)
        corrected = r.copy()
        n_found = 0
        for d in np.nonzero(vals == 0)[0]:
            if self._shift <= d <= self.n - 1 + self._shift:
                p = self.n - 1 + self._shift - d
                if p < self.n:
                    corrected[p] ^= 1
                    n_found += 1
        residual = int((self._syndromes(corrected) != 0).sum())
        if residual != 0 or n_found > self.t:
            raise BchError(f"uncorrectable ({max(residual, n_found)})")
        return corrected[:self.k].copy()

    def decode_batch(self, received_bits):
        """(B, n) bits → ((B, k), ok flags); failed rows hold the systematic
        prefix. Uses the native C++ batch decoder when available."""
        r = np.asarray(received_bits, np.uint8) & 1
        from .. import native
        if native.AVAILABLE:
            res = native.bch_decode_batch(self.n, self.k, self.t, r)
            if res is not None:
                return res
        out = np.empty((r.shape[0], self.k), np.uint8)
        ok = np.ones(r.shape[0], bool)
        for i, row in enumerate(r):
            try:
                out[i] = self.decode(row)
            except BchError:
                out[i] = row[:self.k]
                ok[i] = False
        return out, ok
