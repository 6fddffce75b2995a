"""FEC error-injection matrix — mirrors reference tests/unit/fec.rs (51
tests): per-code/rate/rule roundtrips with injected errors, uncorrectable
rejection, interleaver/scrambler inverses, CRC detection."""

import numpy as np
import pytest
import jax.numpy as jnp

from orion_sdr_tpu.fec.ldpc import ldpc_encode, ldpc_decode, ldpc_graph
from orion_sdr_tpu.fec.conv import (conv_encode_punctured,
                                    punctured_coded_len,
                                    viterbi_decode_soft, tail_bits)
from orion_sdr_tpu.fec.galois import ReedSolomon, Bch, RsError, BchError
from orion_sdr_tpu.fec.interleave import (block_interleave, block_deinterleave,
                                          forney_interleave,
                                          forney_deinterleave, forney_flush,
                                          conv_roundtrip_delay)
from orion_sdr_tpu.fec.scrambler import (pn_sequence, scramble,
                                         PnScramblerStream)
from orion_sdr_tpu.fec.crc import crc16, crc32


# ── LDPC: codes × decode rules, error-injected ───────────────────────────────

@pytest.mark.parametrize("code", ["N512R12", "N576R23", "N512R34"])
@pytest.mark.parametrize("rule", ["sum_product", "min_sum", "scaled_min_sum"])
def test_ldpc_code_rule_error_injected(code, rule):
    g = ldpc_graph(code)
    rng = np.random.default_rng(len(code) * 100 + len(rule))
    msg = rng.integers(0, 2, (8, g.k)).astype(np.uint8)
    cw = np.asarray(ldpc_encode(code, msg))
    llr = (1.0 - 2.0 * cw).astype(np.float32) * 4.0
    # flip a few positions per codeword (higher-rate codes have less
    # margin, and min-sum costs ~0.3-1 dB vs sum-product)
    n_flip = {"N512R12": 8, "N576R23": 4, "N512R34": 3}[code]
    for i in range(len(llr)):
        pos = rng.choice(g.n, n_flip, replace=False)
        llr[i, pos] = -llr[i, pos]
    bits, unsat = ldpc_decode(code, jnp.asarray(llr), 50, rule)
    assert np.array_equal(np.asarray(bits), msg)
    assert not np.any(np.asarray(unsat))


@pytest.mark.parametrize("code", ["N512R12", "N576R23", "N512R34"])
def test_ldpc_uncorrectable_flagged(code):
    g = ldpc_graph(code)
    rng = np.random.default_rng(7)
    llr = rng.standard_normal((4, g.n)).astype(np.float32) * 0.5
    _, unsat = ldpc_decode(code, jnp.asarray(llr), 20)
    assert np.any(np.asarray(unsat)), "random noise should not be a codeword"


# ── convolutional: rates × codes ─────────────────────────────────────────────

@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
@pytest.mark.parametrize("rate", ["1/2", "2/3", "3/4", "5/6", "7/8"])
def test_conv_punctured_noiseless_roundtrip(code, rate):
    rng = np.random.default_rng(len(code) * 1000 + len(rate))
    info = rng.integers(0, 2, 400).astype(np.uint8)
    coded = np.asarray(conv_encode_punctured(info, rate, code))
    assert len(coded) == punctured_coded_len(len(info), rate, code)
    llr = (1.0 - 2.0 * coded).astype(np.float32) * 4.0
    out = np.asarray(viterbi_decode_soft(llr, len(info), rate, code))
    assert np.array_equal(out, info)


@pytest.mark.parametrize("code", ["k5", "dvb_k7"])
@pytest.mark.parametrize("rate", ["1/2", "3/4"])
def test_conv_corrects_flips(code, rate):
    rng = np.random.default_rng(len(code) * 1000 + len(rate) + 7)
    info = rng.integers(0, 2, 400).astype(np.uint8)
    coded = np.asarray(conv_encode_punctured(info, rate, code))
    llr = (1.0 - 2.0 * coded).astype(np.float32) * 4.0
    n_flip = 10 if rate == "1/2" else 4
    pos = rng.choice(len(llr), n_flip, replace=False)
    llr[pos] = -llr[pos]
    out = np.asarray(viterbi_decode_soft(llr, len(info), rate, code))
    assert np.array_equal(out, info)


def test_conv_erasures_decode():
    # zeroed LLRs (erasures from puncturing/fades) still decode at r1/2
    rng = np.random.default_rng(3)
    info = rng.integers(0, 2, 300).astype(np.uint8)
    coded = np.asarray(conv_encode_punctured(info, "1/2", "dvb_k7"))
    llr = (1.0 - 2.0 * coded).astype(np.float32) * 4.0
    llr[::7] = 0.0
    out = np.asarray(viterbi_decode_soft(llr, len(info), "1/2", "dvb_k7"))
    assert np.array_equal(out, info)


# ── Reed-Solomon: configs, correct ≤t, reject >t ─────────────────────────────

@pytest.mark.parametrize("n,n_parity", [(204, 16), (60, 8), (255, 32)])
def test_rs_corrects_up_to_t(n, n_parity):
    rs = ReedSolomon(n, n_parity)
    t = n_parity // 2
    rng = np.random.default_rng(n)
    msg = rng.integers(0, 256, rs.k).astype(np.uint8)
    cw = rs.encode(msg)
    for n_err in (1, t // 2, t):
        bad = cw.copy()
        pos = rng.choice(n, n_err, replace=False)
        bad[pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
        assert np.array_equal(rs.decode(bad)[:rs.k], msg)


@pytest.mark.parametrize("n,n_parity", [(204, 16), (60, 8)])
def test_rs_rejects_beyond_t(n, n_parity):
    rs = ReedSolomon(n, n_parity)
    t = n_parity // 2
    rng = np.random.default_rng(n + 1)
    msg = rng.integers(0, 256, rs.k).astype(np.uint8)
    cw = rs.encode(msg)
    bad = cw.copy()
    pos = rng.choice(n, 2 * t + 3, replace=False)
    bad[pos] ^= rng.integers(1, 256, len(pos)).astype(np.uint8)
    with pytest.raises(RsError):
        rs.decode(bad)


@pytest.mark.parametrize("n,n_parity", [(204, 16), (60, 8), (255, 32)])
def test_rs_native_batch_matches_python(n, n_parity):
    from orion_sdr_tpu import native
    rs = ReedSolomon(n, n_parity)
    t = n_parity // 2
    rng = np.random.default_rng(n + 2)
    B = 32
    msgs = rng.integers(0, 256, (B, rs.k)).astype(np.uint8)
    cw = np.stack([rs.encode(m) for m in msgs]).astype(np.uint8)
    for i in range(B):
        n_err = int(rng.integers(0, t + 1))
        if n_err:
            pos = rng.choice(n, n_err, replace=False)
            cw[i, pos] ^= rng.integers(1, 256, n_err).astype(np.uint8)
    out, ok = rs.decode_batch(cw)
    assert ok.all() and np.array_equal(out, msgs)


# ── BCH: t sweep ─────────────────────────────────────────────────────────────

@pytest.mark.parametrize("t", [2, 4, 8])
def test_bch_corrects_up_to_t(t):
    bch = Bch(t)
    rng = np.random.default_rng(t)
    msg = rng.integers(0, 2, bch.k).astype(np.uint8)
    cw = bch.encode(msg)
    for n_err in (1, t):
        bad = cw.copy()
        pos = rng.choice(bch.n, n_err, replace=False)
        bad[pos] ^= 1
        assert np.array_equal(bch.decode(bad)[:bch.k], msg)


@pytest.mark.parametrize("t", [2, 8])
def test_bch_shortened_corrects(t):
    from orion_sdr_tpu.frame.chain import shortened_bch_for
    bch = shortened_bch_for(t)
    rng = np.random.default_rng(t + 10)
    msg = rng.integers(0, 2, bch.k).astype(np.uint8)
    cw = bch.encode(msg)
    bad = cw.copy()
    pos = rng.choice(bch.n, t, replace=False)
    bad[pos] ^= 1
    assert np.array_equal(bch.decode(bad)[:bch.k], msg)


def test_bch_beyond_t_never_silently_wrong_about_success():
    # past t errors a bounded-distance decoder may miscorrect to ANOTHER
    # codeword (that is information-theoretically unavoidable) but must
    # either raise or return a word differing from the original
    bch = Bch(4)
    rng = np.random.default_rng(99)
    msg = rng.integers(0, 2, bch.k).astype(np.uint8)
    cw = bch.encode(msg)
    raised_or_wrong = 0
    for trial in range(6):
        bad = cw.copy()
        pos = rng.choice(bch.n, 40, replace=False)
        bad[pos] ^= 1
        try:
            out = bch.decode(bad)
            raised_or_wrong += not np.array_equal(out[:bch.k], msg)
        except BchError:
            raised_or_wrong += 1
    assert raised_or_wrong == 6


# ── interleavers: inverses in both domains ───────────────────────────────────

@pytest.mark.parametrize("rows,cols", [(8, 8), (16, 32), (3, 97)])
def test_block_interleaver_inverse_u8(rows, cols):
    rng = np.random.default_rng(rows * cols)
    x = rng.integers(0, 256, (rows * cols,)).astype(np.uint8)
    y = np.asarray(block_interleave(jnp.asarray(x), rows, cols))
    assert not np.array_equal(y, x) or rows == 1 or cols == 1
    back = np.asarray(block_deinterleave(jnp.asarray(y), rows, cols))
    assert np.array_equal(back, x)


@pytest.mark.parametrize("rows,cols", [(16, 32)])
def test_block_interleaver_inverse_f32(rows, cols):
    rng = np.random.default_rng(5)
    x = rng.standard_normal(rows * cols).astype(np.float32)
    y = np.asarray(block_interleave(jnp.asarray(x), rows, cols))
    back = np.asarray(block_deinterleave(jnp.asarray(y), rows, cols))
    assert np.array_equal(back, x)


@pytest.mark.parametrize("I,M", [(12, 17), (4, 5), (2, 1)])
def test_forney_roundtrip_delay(I, M):
    """interleave → flush interleaver lines → deinterleave: every byte comes
    out exactly roundtrip_delay = I·(I−1)·M positions late."""
    rng = np.random.default_rng(I * M)
    d = conv_roundtrip_delay(I, M)
    x = rng.integers(0, 256, 4 * d).astype(np.uint8)
    mid, sti = forney_interleave(x, I, M)
    tail_i, _ = forney_flush(I, M, sti, deinterleave=False)
    stream = np.concatenate([np.asarray(mid), np.asarray(tail_i)])
    out, _ = forney_deinterleave(stream, I, M)
    full = np.asarray(out)
    assert np.array_equal(full[d:d + len(x)], x)


@pytest.mark.parametrize("I,M", [(12, 17)])
def test_forney_streaming_chunk_invariance(I, M):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, 7000).astype(np.uint8)
    one, _ = forney_deinterleave(x, I, M)
    parts, st = [], None
    for i in range(0, len(x), 613):
        p, st = forney_deinterleave(x[i:i + 613], I, M, st)
        parts.append(np.asarray(p))
    assert np.array_equal(np.concatenate(parts), np.asarray(one))


# ── scramblers ───────────────────────────────────────────────────────────────

@pytest.mark.parametrize("poly,width", [(0b1001, 7), (0b1001, 15),
                                        (0b1100101, 32)])
def test_pn_scrambler_self_inverse(poly, width):
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, 512).astype(np.uint8)
    seed = 0x5A5A5A5A & ((1 << width) - 1) or 1
    once = scramble(data, poly, width, seed)
    twice = scramble(np.asarray(once), poly, width, seed)
    assert np.array_equal(np.asarray(twice), data)
    assert not np.array_equal(np.asarray(once), data)


def test_pn_stream_continuation_matches_one_shot():
    rng = np.random.default_rng(11)
    data = rng.integers(0, 256, 1000).astype(np.uint8)
    one = np.asarray(scramble(data, 0b1001, 15, 0x1FF))
    s = PnScramblerStream(0b1001, 15, 0x1FF)
    parts = [s.feed(data[:301]), s.feed(data[301:702]),
             s.feed(data[702:])]
    assert np.array_equal(np.concatenate(parts), one)


# ── CRC detection ────────────────────────────────────────────────────────────

@pytest.mark.parametrize("fn,width", [(crc16, 16), (crc32, 32)])
def test_crc_detects_single_bit_errors(fn, width):
    rng = np.random.default_rng(width)
    data = rng.integers(0, 256, 64).astype(np.uint8)
    good = fn(bytes(data))
    for pos in (0, 13, 63):
        for bit in (0, 7):
            bad = data.copy()
            bad[pos] ^= 1 << bit
            assert fn(bytes(bad)) != good


def test_crc_known_answers():
    # CRC-16/CCITT-FALSE and CRC-32/ISO-HDLC of "123456789"
    assert crc16(b"123456789") == 0x29B1
    assert crc32(b"123456789") == 0xCBF43926


def test_rs_large_parity_takes_numpy_path():
    """Regression: RS configs beyond the native fast path's fixed buffers
    (n_parity > 64) must fall through to numpy, not overrun the stack."""
    rs = ReedSolomon(255, 80)
    rng = np.random.default_rng(80)
    msg = rng.integers(0, 256, (3, rs.k)).astype(np.uint8)
    cw = np.stack([rs.encode(m) for m in msg]).astype(np.uint8)
    cw[0, 3] ^= 0x55
    cw[1, 10] ^= 0x0F
    out, ok = rs.decode_batch(cw)
    assert ok.all() and np.array_equal(out, msg)


# ── batched on-device BCH/RS decoders (fec/bch_device.py) ────────────────────

from orion_sdr_tpu.fec.bch_device import (bch_decode_batch_device,
                                          rs_decode_batch_device,
                                          gf_mul as gf_mul_dev,
                                          gf_inv as gf_inv_dev)


def test_device_gf_primitives():
    from orion_sdr_tpu.fec.galois import gf_mul as gf_mul_host
    rng = np.random.default_rng(1)
    a = rng.integers(0, 256, 500)
    b = rng.integers(0, 256, 500)
    dev = np.asarray(gf_mul_dev(a, b))
    host = np.array([int(gf_mul_host(np.uint8(x), np.uint8(y)))
                     for x, y in zip(a, b)])
    assert np.array_equal(dev, host)
    inv = np.asarray(gf_inv_dev(np.arange(1, 256)))
    assert np.all(np.asarray(gf_mul_dev(np.arange(1, 256), inv)) == 1)


@pytest.mark.parametrize("t,n", [(8, 184), (4, 255)])
def test_device_bch_matches_host(t, n):
    bch = Bch(t, n)
    rng = np.random.default_rng(t * 100 + n)
    B = 48
    msgs = rng.integers(0, 2, (B, bch.k)).astype(np.uint8)
    cw = bch.encode(msgs.reshape(B, bch.k)).astype(np.uint8)
    bad = cw.copy()
    for i in range(B):
        ne = int(rng.integers(0, t + 1))
        if ne:
            pos = rng.choice(n, ne, replace=False)
            bad[i, pos] ^= 1
    bad[0, ::3] ^= 1                      # one uncorrectable row
    out, okd = bch_decode_batch_device(n, bch.k, t, bad)
    ref_out, ref_ok = bch.decode_batch(bad)
    assert np.array_equal(np.asarray(out), ref_out)
    assert np.array_equal(np.asarray(okd).astype(bool), ref_ok)


@pytest.mark.parametrize("n,p", [(204, 16)])
def test_device_rs_matches_host(n, p):
    rs = ReedSolomon(n, p)
    rng = np.random.default_rng(n + p)
    B = 32
    msgs = rng.integers(0, 256, (B, rs.k)).astype(np.uint8)
    cw = np.stack([rs.encode(m) for m in msgs]).astype(np.uint8)
    bad = cw.copy()
    for i in range(B):
        ne = int(rng.integers(0, p // 2 + 1))
        if ne:
            pos = rng.choice(n, ne, replace=False)
            bad[i, pos] ^= rng.integers(1, 256, ne).astype(np.uint8)
    bad[0, ::3] ^= 0xA5                   # one uncorrectable row
    out, okd = rs_decode_batch_device(n, p, bad)
    ref_out, ref_ok = rs.decode_batch(bad)
    assert np.array_equal(np.asarray(out), ref_out)
    assert np.array_equal(np.asarray(okd).astype(bool), ref_ok)


@pytest.mark.parametrize("t,n", [(8, 184), (8, 255), (5, 167), (2, 63)])
def test_device_bch_encode_matches_host(t, n):
    """Device matmul encode (fec/bch_device.py::bch_encode_batch_device)
    is bit-exact vs the numpy LFSR reference and survives a decode roundtrip."""
    from orion_sdr_tpu.fec.bch_device import bch_encode_batch_device
    bch = Bch(t, n)
    rng = np.random.default_rng(7 * t + n)
    B = 24
    msgs = rng.integers(0, 2, (B, bch.k)).astype(np.uint8)
    dev = np.asarray(bch_encode_batch_device(n, bch.k, t, msgs))
    ref = np.stack([bch.encode(m) for m in msgs])
    assert np.array_equal(dev, ref)
    dec, ok = bch.decode_batch(dev)
    assert ok.all() and np.array_equal(dec, msgs)


@pytest.mark.parametrize("n,p", [(204, 16), (60, 8), (255, 16)])
def test_device_rs_encode_matches_host(n, p):
    """Device GF(2)-linearized RS encode (fec/bch_device.py::
    rs_encode_batch_device) is byte-exact vs the host LFSR and survives a
    decode roundtrip with injected errors."""
    from orion_sdr_tpu.fec.bch_device import rs_encode_batch_device
    rs = ReedSolomon(n, p)
    rng = np.random.default_rng(3 * n + p)
    B = 24
    msgs = rng.integers(0, 256, (B, rs.k)).astype(np.uint8)
    dev = np.array(rs_encode_batch_device(n, p, msgs))
    ref = rs.encode(msgs)
    assert np.array_equal(dev, ref)
    for row in dev[:4]:
        idx = rng.choice(n, p // 2, replace=False)
        row[idx] ^= rng.integers(1, 256, p // 2).astype(np.uint8)
    dec, ok = rs.decode_batch(dev)
    assert ok.all() and np.array_equal(dec, msgs)


def test_outer_encode_device_path_matches_host(monkeypatch):
    """outer_encode produces identical bits whether it dispatches to the
    device encoders or the host path (gate forced open on CPU)."""
    from orion_sdr_tpu.frame import chain
    rng = np.random.default_rng(5)
    payload = rng.integers(0, 256, 2200).astype(np.uint8)  # >64 blocks both
    for outer in (chain.OuterFec.bch(8), chain.OuterFec.reed_solomon(60, 8)):
        host = chain.outer_encode(outer, payload)
        monkeypatch.setattr(chain, "outer_on_device", lambda t, nb: True)
        dev = chain.outer_encode(outer, payload)
        monkeypatch.undo()
        assert np.array_equal(host, dev), outer.kind


def test_outer_device_gate_logic(monkeypatch):
    """The device outer decoders run only on a GPU, only for batches of at
    least the measured crossover, and only for t the device code supports."""
    import jax
    from orion_sdr_tpu.fec.bch_device import MAX_DEVICE_T
    from orion_sdr_tpu.frame.chain import (outer_on_device,
                                           _DEVICE_OUTER_MIN_BLOCKS as n_min)
    assert not outer_on_device(8, 1000)        # CPU backend in tests
    assert not outer_on_device(8, 10 ** 6)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert outer_on_device(8, n_min)
    assert not outer_on_device(8, n_min - 1)
    assert not outer_on_device(MAX_DEVICE_T + 1, n_min)
