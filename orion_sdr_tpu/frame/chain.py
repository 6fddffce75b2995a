"""Shared TX/RX coding chain + BlockPlan (behavioral spec:
modulate/ofdm_frame.rs:210-640, demodulate/ofdm_frame.rs:40-436).

BlockPlan arithmetic is plain Python ints at trace time — static shape
bookkeeping, the natural fit for XLA's static shapes (SURVEY §7 item 8).
The per-block FEC codecs run batched: fragments are stacked on a leading
axis so LDPC encode/BP decode is one device call per chain stage.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import jax
import jax.numpy as jnp

from ..fec import (
    ldpc_graph, ldpc_encode, ldpc_decode,
    conv_encode_punctured, punctured_coded_len, viterbi_decode_soft,
    viterbi_decode_soft_chunked,
    block_interleave, block_deinterleave,
    forney_interleave, forney_deinterleave, forney_flush, conv_roundtrip_delay,
    pn_sequence, crc16, crc32,
)
from ..fec.galois import Bch, ReedSolomon, RsError, BchError
from ..waveform.dvb_t import energy_disperse
from .types import (
    OuterFec, InnerFec, InterleaverKind, ScramblerKind, crc_len_bytes,
    SCRAMBLER_BEFORE_OUTER, SCRAMBLER_AFTER_INNER, RxError,
)

# Fixed info-bit block for the outer BCH (one shortened codeword per block;
# n = k + parity ≤ 255 for the t values used). ref :484-487.
BCH_INFO_BITS = 120

_BCH_CACHE: dict = {}
_RS_CACHE: dict = {}


def shortened_bch_for(t: int, msg_bits: int = BCH_INFO_BITS) -> Bch:
    """BCH correcting t errors, shortened to exactly msg_bits info bits —
    memoized (the reference's CodecCache; here codes are cheap tables but
    jitted decode paths key off object identity)."""
    key = (t, msg_bits)
    if key not in _BCH_CACHE:
        full = Bch(t)
        _BCH_CACHE[key] = Bch(t, n=msg_bits + full.parity_bits)
    return _BCH_CACHE[key]


def rs_for(n: int, n_parity: int) -> ReedSolomon:
    key = (n, n_parity)
    if key not in _RS_CACHE:
        _RS_CACHE[key] = ReedSolomon(n, n_parity)
    return _RS_CACHE[key]


# ── bit/byte helpers ─────────────────────────────────────────────────────────


def bytes_to_bits(b) -> np.ndarray:
    return np.unpackbits(np.asarray(b, np.uint8))


def bits_to_bytes(bits) -> np.ndarray:
    return np.packbits(np.asarray(bits, np.uint8))


def _pack_bits_padded(bits) -> np.ndarray:
    bits = np.asarray(bits, np.uint8)
    rem = (-len(bits)) % 8
    if rem:
        bits = np.concatenate([bits, np.zeros(rem, np.uint8)])
    return np.packbits(bits)


def _round_up(n: int, block: int) -> int:
    return n if block == 0 else -(-n // block) * block


# ── CRC ──────────────────────────────────────────────────────────────────────


def append_crc(crc: str, data: np.ndarray) -> np.ndarray:
    data = np.asarray(data, np.uint8)
    if crc == "none":
        return data.copy()
    if crc == "crc16":
        v = crc16(data)
        return np.concatenate([data, np.array([v >> 8, v & 0xFF], np.uint8)])
    v = crc32(data)
    return np.concatenate([data, np.frombuffer(
        int(v).to_bytes(4, "big"), np.uint8)])


def check_and_strip_crc(crc: str, framed: np.ndarray):
    """Returns (bytes, crc_ok) or None if too short (ref :check_and_strip_crc)."""
    framed = np.asarray(framed, np.uint8)
    n = crc_len_bytes(crc)
    if len(framed) < n:
        return None
    if n == 0:
        return framed.copy(), True
    body, tail = framed[:-n], framed[-n:]
    if crc == "crc16":
        want = (int(tail[0]) << 8) | int(tail[1])
        return body.copy(), crc16(body) == want
    want = int.from_bytes(bytes(tail), "big")
    return body.copy(), crc32(body) == want


# ── scramblers ───────────────────────────────────────────────────────────────


def scramble_bytes(kind: ScramblerKind, per_frame_seed: int,
                   data: np.ndarray) -> np.ndarray:
    """Byte-domain whitener (self-inverse)."""
    data = np.asarray(data, np.uint8)
    if kind.kind == "none":
        return data.copy()
    if kind.kind == "dvb":
        return energy_disperse(data)
    raw = per_frame_seed if kind.seed_mode == "per_frame" else kind.seed
    # reduce into the register width; avoid the all-zero fixed point
    # (deterministic on both ends — ref build_scrambler, ofdm_frame.rs:277-289)
    mask = (1 << kind.width) - 1
    seed = raw & mask or 1
    pn = pn_sequence(kind.poly, kind.width, seed, len(data))
    return data ^ pn


def _pn_bits(kind: ScramblerKind, per_frame_seed: int, n_bits: int) -> np.ndarray:
    n_bytes = -(-n_bits // 8)
    zero = np.zeros(n_bytes, np.uint8)
    return np.unpackbits(scramble_bytes(kind, per_frame_seed, zero))[:n_bits]


def scramble_bits(kind: ScramblerKind, per_frame_seed: int, bits) -> np.ndarray:
    """Bit-domain position: pack → XOR PN → unpack (ref scramble_bits)."""
    bits = np.asarray(bits, np.uint8)
    return bits ^ _pn_bits(kind, per_frame_seed, len(bits))


def apply_pn_to_llrs(kind: ScramblerKind, per_frame_seed: int, llrs) -> np.ndarray:
    """Descramble in the LLR domain: negate where PN==1 (ref :424-436)."""
    llrs = np.asarray(llrs, np.float32)
    pn = _pn_bits(kind, per_frame_seed, len(llrs))
    return np.where(pn != 0, -llrs, llrs)


# ── interleavers (frame mode) ────────────────────────────────────────────────


def _conv_il_bits(n_bits: int, branches: int, depth: int) -> int:
    byts = _round_up(-(-n_bits // 8), branches) + \
        conv_roundtrip_delay(branches, depth)
    return byts * 8


def interleave_bits(il: InterleaverKind, bits) -> np.ndarray:
    bits = np.asarray(bits, np.uint8)
    if il.kind == "none":
        return bits.copy()
    if il.kind == "block":
        block = il.rows * il.cols
        n = _round_up(len(bits), block)
        padded = np.concatenate([bits, np.zeros(n - len(bits), np.uint8)])
        chunks = padded.reshape(-1, block)
        out = np.asarray(block_interleave(jnp.asarray(chunks), il.rows, il.cols))
        return out.reshape(-1).astype(np.uint8)
    # Forney, frame mode: byte-pack, align to branches, feed + flush.
    byts = _pack_bits_padded(bits)
    n = _round_up(len(byts), il.branches)
    padded = np.concatenate([byts, np.zeros(n - len(byts), np.uint8)])
    body, state = forney_interleave(jnp.asarray(padded), il.branches, il.depth)
    tail, _ = forney_flush(il.branches, il.depth, state)
    return np.unpackbits(np.concatenate([np.asarray(body), np.asarray(tail)]
                                        ).astype(np.uint8))


def _deinterleave(il: InterleaverKind, x, is_llr: bool):
    x = np.asarray(x)
    if il.kind == "none":
        return x.copy()
    if il.kind == "block":
        block = il.rows * il.cols
        n_full = (len(x) // block) * block
        full = x[:n_full].reshape(-1, block)
        out = np.asarray(block_deinterleave(jnp.asarray(full), il.rows, il.cols))
        return np.concatenate([out.reshape(-1), x[n_full:]])
    # Forney inverse, frame mode (byte domain only).
    if is_llr:
        # never configured as the inner (LLR) interleaver; degrade gracefully
        return x.copy()
    d = conv_roundtrip_delay(il.branches, il.depth)
    total = len(x) // 8
    if total <= d:
        return np.zeros(0, np.uint8)
    n_padded = total - d
    byts = np.packbits(x[: total * 8].astype(np.uint8))
    body, state = forney_deinterleave(jnp.asarray(byts), il.branches, il.depth)
    out = np.asarray(body)
    if len(out) < d + n_padded:
        tail, _ = forney_flush(il.branches, il.depth, state, deinterleave=True)
        out = np.concatenate([out, np.asarray(tail)])
    return np.unpackbits(out[d:d + n_padded].astype(np.uint8))


def deinterleave_bits(il: InterleaverKind, bits) -> np.ndarray:
    return _deinterleave(il, np.asarray(bits, np.uint8), is_llr=False)


def deinterleave_llrs(il: InterleaverKind, llrs) -> np.ndarray:
    return _deinterleave(il, np.asarray(llrs, np.float32), is_llr=True)


# ── BlockPlan ────────────────────────────────────────────────────────────────


@dataclass(frozen=True)
class BlockPlan:
    """Deterministic TX/RX-shared length accounting (ref :316-338)."""
    info_bytes: int
    framed_bytes: int
    outer_coded_bits: int
    outer_il_bits: int
    inner_coded_bits: int
    coded_bits: int


def block_plan(info_bytes: int, crc: str, outer: OuterFec, inner: InnerFec,
               outer_il: InterleaverKind, inner_il: InterleaverKind
               ) -> BlockPlan:
    framed_bytes = info_bytes + crc_len_bytes(crc)
    framed_bits = framed_bytes * 8

    if outer.kind == "none":
        outer_coded_bits = framed_bits
    elif outer.kind == "bch":
        code = shortened_bch_for(outer.t)
        outer_coded_bits = -(-framed_bits // BCH_INFO_BITS) * code.n
    else:
        rs = rs_for(outer.n, outer.n_parity)
        outer_coded_bits = -(-framed_bytes // rs.k) * rs.n * 8

    if outer_il.kind == "none":
        outer_il_bits = outer_coded_bits
    elif outer_il.kind == "block":
        outer_il_bits = _round_up(outer_coded_bits, outer_il.rows * outer_il.cols)
    else:
        outer_il_bits = _conv_il_bits(outer_coded_bits, outer_il.branches,
                                      outer_il.depth)

    if inner.kind == "none":
        inner_coded_bits = outer_il_bits
    elif inner.kind == "ldpc":
        g = ldpc_graph(inner.code)
        inner_coded_bits = -(-outer_il_bits // g.k) * g.n
    else:
        inner_coded_bits = punctured_coded_len(outer_il_bits, inner.rate,
                                               inner.code)

    if inner_il.kind == "none":
        coded_bits = inner_coded_bits
    elif inner_il.kind == "block":
        coded_bits = _round_up(inner_coded_bits, inner_il.rows * inner_il.cols)
    else:
        coded_bits = _conv_il_bits(inner_coded_bits, inner_il.branches,
                                   inner_il.depth)

    return BlockPlan(info_bytes, framed_bytes, outer_coded_bits,
                     outer_il_bits, inner_coded_bits, coded_bits)


# ── encode side ──────────────────────────────────────────────────────────────


def outer_encode(outer: OuterFec, message_bytes) -> np.ndarray:
    message_bytes = np.asarray(message_bytes, np.uint8)
    if outer.kind == "none":
        return bytes_to_bits(message_bytes)
    if outer.kind == "bch":
        code = shortened_bch_for(outer.t)
        bits = bytes_to_bits(message_bytes)
        n_blk = -(-len(bits) // BCH_INFO_BITS)
        padded = np.concatenate([bits, np.zeros(
            n_blk * BCH_INFO_BITS - len(bits), np.uint8)])
        blocks = padded.reshape(n_blk, BCH_INFO_BITS)
        if outer_on_device(outer.t, n_blk):
            from ..fec.bch_device import bch_encode_batch_device
            return np.asarray(bch_encode_batch_device(
                code.n, code.k, code.t, blocks)).reshape(-1)
        return code.encode(blocks).reshape(-1)
    rs = rs_for(outer.n, outer.n_parity)
    n_blk = -(-len(message_bytes) // rs.k)
    padded = np.concatenate([message_bytes, np.zeros(
        n_blk * rs.k - len(message_bytes), np.uint8)])
    blocks = padded.reshape(n_blk, rs.k)
    if outer_on_device(outer.n_parity // 2, n_blk):
        from ..fec.bch_device import rs_encode_batch_device
        coded = np.asarray(rs_encode_batch_device(rs.n, rs.n_parity, blocks))
    else:
        coded = rs.encode(blocks)                    # batched LFSR
    return bytes_to_bits(coded.reshape(-1))


def inner_encode(inner: InnerFec, info_bits) -> np.ndarray:
    info_bits = np.asarray(info_bits, np.uint8)
    if inner.kind == "none":
        return info_bits.copy()
    if inner.kind == "ldpc":
        g = ldpc_graph(inner.code)
        n_blk = -(-len(info_bits) // g.k)
        padded = np.concatenate([info_bits, np.zeros(
            n_blk * g.k - len(info_bits), np.uint8)])
        return np.asarray(ldpc_encode(inner.code,
                                      padded.reshape(n_blk, g.k))).reshape(-1)
    return np.asarray(conv_encode_punctured(info_bits, inner.rate, inner.code))


def encode_chain(data_bytes, crc: str, outer: OuterFec, inner: InnerFec,
                 outer_il: InterleaverKind, inner_il: InterleaverKind,
                 scrambler: ScramblerKind, scrambler_pos: str,
                 per_frame_seed: int) -> np.ndarray:
    """bytes → CRC → [scramble] → outer → outer-IL → inner → inner-IL →
    [scramble]; returns coded bits ready to map (ref :558-598)."""
    framed = append_crc(crc, data_bytes)
    if scrambler_pos == SCRAMBLER_BEFORE_OUTER:
        framed = scramble_bytes(scrambler, per_frame_seed, framed)
    outer_bits = outer_encode(outer, framed)
    outer_ilb = interleave_bits(outer_il, outer_bits)
    inner_bits = inner_encode(inner, outer_ilb)
    coded = interleave_bits(inner_il, inner_bits)
    if scrambler_pos == SCRAMBLER_AFTER_INNER and scrambler.kind != "none":
        coded = scramble_bits(scrambler, per_frame_seed, coded)
    return coded


# ── decode side ──────────────────────────────────────────────────────────────


def inner_decode(inner: InnerFec, coded_llrs, info_len: int,
                 ldpc_rule: str = "sum_product"):
    """(info_bits, all_ok) — LDPC blocks decode batched (ref :259-305)."""
    llrs = np.asarray(coded_llrs, np.float32)
    if inner.kind == "none":
        return (llrs <= 0.0).astype(np.uint8), True
    if inner.kind == "ldpc":
        g = ldpc_graph(inner.code)
        n_full = len(llrs) // g.n
        ok = n_full * g.n == len(llrs)
        blocks = llrs[: n_full * g.n].reshape(n_full, g.n)
        # Normalize LLR scale per block before BP: the max-log demapper's
        # outputs are unscaled by 1/σ², and sum-product stalls when the
        # magnitudes are ≪1 (min-sum is scale-invariant; sum-product is not).
        # Same trick as FT8's normalise_llr; hard decisions are unaffected.
        rms = np.sqrt(np.mean(blocks ** 2, axis=-1, keepdims=True))
        blocks = blocks * (4.0 / np.maximum(rms, 1e-9))
        msg, unsat = ldpc_decode(inner.code, jnp.asarray(blocks), 50, ldpc_rule)
        ok = ok and not bool(np.any(np.asarray(unsat) != 0))
        return np.asarray(msg).reshape(-1), ok
    return np.asarray(_conv_decode(inner, llrs, info_len)), True


def _conv_decode(inner: InnerFec, llrs, info_len: int):
    """Long streams decode as overlap-chunked trellis lanes, short ones as
    one terminated trellis."""
    if info_len > 4096:
        return viterbi_decode_soft_chunked(llrs, info_len, inner.rate,
                                           inner.code)
    return viterbi_decode_soft(llrs, info_len, inner.rate, inner.code)


# from this many codewords on, the batched device BCH/RS decoders
# (fec/bch_device.py, one program per batch, host copies included) beat the
# native host decoders. H100 at 700 W: the device call costs a flat ~1.0-1.3
# ms from 51 to 1616 codewords, native RS(204,188) and BCH t=8 ~2-5 us per
# codeword (tools/gpu_timings.py; PERF.md). The encoders share the gate;
# their own crossover is not measured.
_DEVICE_OUTER_MIN_BLOCKS = 200


def outer_on_device(t: int, n_blocks: int) -> bool:
    """Whether a batch of ``n_blocks`` BCH/RS codewords correcting ``t``
    errors runs on the device (fec/bch_device.py) instead of the native
    host decoders."""
    from ..fec.bch_device import MAX_DEVICE_T
    return (jax.default_backend() == "gpu" and t <= MAX_DEVICE_T
            and n_blocks >= _DEVICE_OUTER_MIN_BLOCKS)


def outer_decode(outer: OuterFec, coded_bits):
    """(message_bits, all_ok); per-block failures fall back to the systematic
    prefix so the CRC still adjudicates (ref :309-360)."""
    bits = np.asarray(coded_bits, np.uint8)
    if outer.kind == "none":
        return bits.copy(), True
    if outer.kind == "bch":
        code = shortened_bch_for(outer.t)
        n = code.n
        n_full = len(bits) // n
        if n_full == 0:
            return np.zeros(0, np.uint8), False
        blocks = bits[: n_full * n].reshape(n_full, n)
        if outer_on_device(outer.t, n_full):
            from ..fec.bch_device import bch_decode_batch_device
            msg, okd = bch_decode_batch_device(n, code.k, code.t, blocks)
            msg, ok = np.asarray(msg), np.asarray(okd).astype(bool)
        else:
            msg, ok = code.decode_batch(blocks)  # native C++ when available
        return msg.reshape(-1), bool(ok.all()) and len(bits) % n == 0
    rs = rs_for(outer.n, outer.n_parity)
    byts = bits_to_bytes(bits)
    n = rs.n
    n_full = len(byts) // n
    if n_full == 0:
        return np.zeros(0, np.uint8), False
    blocks = byts[: n_full * n].reshape(n_full, n)
    if outer_on_device(outer.n_parity // 2, n_full):
        from ..fec.bch_device import rs_decode_batch_device
        msg, okd = rs_decode_batch_device(n, outer.n_parity, blocks)
        msg, ok = np.asarray(msg), np.asarray(okd).astype(bool)
    else:
        msg, ok = rs.decode_batch(blocks)        # native C++ when available
    return bytes_to_bits(msg.reshape(-1)), \
        bool(ok.all()) and len(byts) % n == 0


def inner_decode_batch(inner: InnerFec, coded_llrs_mat, info_len: int,
                       ldpc_rule: str = "sum_product"):
    """(B, L) LLRs → ((B, info) bits, (B,) ok): ALL frames' FEC blocks decode
    in ONE device call (batched BP / batched trellis)."""
    llrs = np.asarray(coded_llrs_mat, np.float32)
    nb = llrs.shape[0]
    if inner.kind == "none":
        return (llrs <= 0.0).astype(np.uint8), np.ones(nb, bool)
    if inner.kind == "ldpc":
        g = ldpc_graph(inner.code)
        n_full = llrs.shape[1] // g.n
        len_ok = n_full * g.n == llrs.shape[1]
        blocks = llrs[:, : n_full * g.n].reshape(nb * n_full, g.n)
        rms = np.sqrt(np.mean(blocks ** 2, axis=-1, keepdims=True))
        blocks = blocks * (4.0 / np.maximum(rms, 1e-9))
        msg, unsat = ldpc_decode(inner.code, jnp.asarray(blocks), 50, ldpc_rule)
        ok = len_ok & (np.asarray(unsat).reshape(nb, n_full) == 0).all(axis=1)
        return np.asarray(msg).reshape(nb, -1), ok
    return np.asarray(_conv_decode(inner, llrs, info_len)), np.ones(nb, bool)


def outer_decode_batch(outer: OuterFec, coded_bits_mat):
    """(B, L) bits → ((B, msg) bits, (B,) ok): all frames' codewords run
    through one batch BM+Chien+Forney pass (native C++ when available)."""
    bits = np.asarray(coded_bits_mat, np.uint8)
    nb, nbits = bits.shape
    if outer.kind == "none":
        return bits.copy(), np.ones(nb, bool)
    if outer.kind == "bch":
        code = shortened_bch_for(outer.t)
        n = code.n
        n_full = nbits // n
        if n_full == 0:
            return np.zeros((nb, 0), np.uint8), np.zeros(nb, bool)
        blocks = bits[:, : n_full * n].reshape(nb * n_full, n)
        if outer_on_device(outer.t, nb * n_full):
            from ..fec.bch_device import bch_decode_batch_device
            msg, okd = bch_decode_batch_device(n, code.k, code.t, blocks)
            msg, ok = np.asarray(msg), np.asarray(okd).astype(bool)
        else:
            msg, ok = code.decode_batch(blocks)
        ok = ok.reshape(nb, n_full).all(axis=1) & (nbits % n == 0)
        return msg.reshape(nb, -1), ok
    rs = rs_for(outer.n, outer.n_parity)
    byts = np.packbits(bits, axis=1)
    n = rs.n
    n_full = byts.shape[1] // n
    if n_full == 0:
        return np.zeros((nb, 0), np.uint8), np.zeros(nb, bool)
    blocks = byts[:, : n_full * n].reshape(nb * n_full, n)
    if outer_on_device(outer.n_parity // 2, nb * n_full):
        from ..fec.bch_device import rs_decode_batch_device
        msg, okd = rs_decode_batch_device(n, outer.n_parity, blocks)
        msg, ok = np.asarray(msg), np.asarray(okd).astype(bool)
    else:
        msg, ok = rs.decode_batch(blocks)
    ok = ok.reshape(nb, n_full).all(axis=1) & (byts.shape[1] % n == 0)
    return np.unpackbits(msg.reshape(nb, -1), axis=1), ok


def decode_chain_batch(coded_llrs_mat, plan: BlockPlan, crc: str,
                       outer: OuterFec, inner: InnerFec,
                       outer_il: InterleaverKind, inner_il: InterleaverKind,
                       scrambler: ScramblerKind, scrambler_pos: str,
                       per_frame_seeds, ldpc_rule: str = "sum_product"):
    """decode_chain over B same-plan frames at once → (list of byte arrays
    or None, (B,) ok). The device FEC stages batch across frames (the
    whole point: one BP / one trellis decode instead of B device calls);
    the byte-domain stages (PN, interleavers, CRC) loop on host."""
    llrs = np.asarray(coded_llrs_mat, np.float32)[:, : plan.coded_bits]
    nb = llrs.shape[0]
    seeds = [int(s) for s in per_frame_seeds]
    assert len(seeds) == nb
    pre = []
    for b in range(nb):
        row = llrs[b]
        if scrambler_pos == SCRAMBLER_AFTER_INNER and scrambler.kind != "none":
            row = apply_pn_to_llrs(scrambler, seeds[b], row)
        pre.append(deinterleave_llrs(inner_il, row)[: plan.inner_coded_bits])
    inner_bits, inner_ok = inner_decode_batch(inner, np.stack(pre),
                                              plan.outer_il_bits, ldpc_rule)
    inner_bits = inner_bits[:, : plan.outer_il_bits]
    outer_de = np.stack([
        deinterleave_bits(outer_il, row)[: plan.outer_coded_bits]
        for row in inner_bits])
    framed_bits, outer_ok = outer_decode_batch(outer, outer_de)
    datas, oks = [], np.zeros(nb, bool)
    for b in range(nb):
        fb = framed_bits[b][: plan.framed_bytes * 8]
        if len(fb) < plan.framed_bytes * 8:
            datas.append(None)
            continue
        framed = bits_to_bytes(fb)
        if scrambler_pos == SCRAMBLER_BEFORE_OUTER:
            framed = scramble_bytes(scrambler, seeds[b], framed)
        stripped = check_and_strip_crc(crc, framed)
        if stripped is None:
            datas.append(None)
            continue
        data, crc_ok = stripped
        datas.append(data)
        oks[b] = bool(crc_ok) and bool(inner_ok[b]) and bool(outer_ok[b])
    return datas, oks


def decode_chain(coded_llrs, plan: BlockPlan, crc: str, outer: OuterFec,
                 inner: InnerFec, outer_il: InterleaverKind,
                 inner_il: InterleaverKind, scrambler: ScramblerKind,
                 scrambler_pos: str, per_frame_seed: int,
                 ldpc_rule: str = "sum_product"):
    """Exact inverse of encode_chain: (bytes, all_ok) or raises RxError.
    Inner deinterleave runs in the LLR domain, outer in the bit/byte domain
    (ref demodulate/ofdm_frame.rs:364-436)."""
    llrs = np.asarray(coded_llrs, np.float32)[: plan.coded_bits]
    if scrambler_pos == SCRAMBLER_AFTER_INNER and scrambler.kind != "none":
        llrs = apply_pn_to_llrs(scrambler, per_frame_seed, llrs)
    inner_de = deinterleave_llrs(inner_il, llrs)[: plan.inner_coded_bits]
    outer_il_bits, inner_ok = inner_decode(inner, inner_de,
                                           plan.outer_il_bits, ldpc_rule)
    outer_il_bits = outer_il_bits[: plan.outer_il_bits]
    outer_de = deinterleave_bits(outer_il, outer_il_bits)[: plan.outer_coded_bits]
    framed_bits, outer_ok = outer_decode(outer, outer_de)
    framed_bits = framed_bits[: plan.framed_bytes * 8]
    if len(framed_bits) < plan.framed_bytes * 8:
        raise RxError(RxError.MALFORMED_HEADER)
    framed = bits_to_bytes(framed_bits)
    if scrambler_pos == SCRAMBLER_BEFORE_OUTER:
        framed = scramble_bytes(scrambler, per_frame_seed, framed)
    stripped = check_and_strip_crc(crc, framed)
    if stripped is None:
        raise RxError(RxError.MALFORMED_HEADER)
    data, crc_ok = stripped
    return data, (crc_ok and inner_ok and outer_ok)
