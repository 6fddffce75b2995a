"""PSK31 stack tests — mirrors reference tests/unit/psk31.rs +
tests/roundtrip/psk31.rs + performance/snr/psk31.rs thresholds."""

import numpy as np
import pytest

from orion_sdr_tpu.codec import varicode as vc
from orion_sdr_tpu.codec import psk31 as cp
from orion_sdr_tpu.codec.psk31_stream import Psk31Stream
from orion_sdr_tpu.modulate.psk31 import (
    bpsk31_mod_bits, qpsk31_mod_bits, bpsk31_mod_text, qpsk31_mod_text,
    psk31_sps, PSK31_BAUD,
)
from orion_sdr_tpu.demodulate.psk31 import bpsk31_demod, qpsk31_demod, bpsk31_decide
from orion_sdr_tpu.sync.psk31_sync import psk31_sync, best_sync, Psk31SyncResult
from orion_sdr_tpu.sync.waterfall import compute_waterfall

FS = 8000.0


def _awgn(rng, n, power):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * np.sqrt(power / 2)).astype(np.complex64)


def snr_to_noise_power(snr_db, fs=FS, ref_bw=2500.0):
    """Reference calibration (tests/performance/snr/psk31.rs:20-22)."""
    return fs / (ref_bw * 10.0 ** (snr_db / 10.0))


# ── varicode ─────────────────────────────────────────────────────────────────

def test_varicode_known_answers():
    assert vc.varicode_encode(ord(" ")) == (0b1, 1)
    assert vc.varicode_encode(ord("e")) == (0b11, 2)
    assert vc.varicode_encode(ord("t")) == (0b101, 3)
    assert vc.varicode_encode(ord("o")) == (0b111, 3)
    assert vc.varicode_encode(0) == (0b1010101011, 10)


def test_varicode_no_00_inside_codewords():
    for cw, ln in vc.VARICODE:
        s = format(cw, f"0{ln}b")
        assert "00" not in s, s
        assert s[0] == "1" and s[-1] == "1"


def test_varicode_all_chars_roundtrip():
    for i in range(128):
        cw, ln = vc.varicode_encode(i)
        assert vc.varicode_decode(cw, ln) == i


def test_varicode_text_roundtrip():
    msg = "Hello, World! 123 [~]"
    bits = vc.encode_text(msg, 32, 32)
    assert vc.decode_bits(bits) == msg


def test_varicode_streaming_chunked():
    bits = vc.encode_text("chunked stream", 16, 16)
    dec = vc.VaricodeDecoder()
    out = "".join(dec.push_bits([b]) for b in bits)
    out += dec.push_bits([0, 0])
    assert out == "chunked stream"


# ── conv / viterbi ───────────────────────────────────────────────────────────

def test_conv_encode_known():
    # x = [1]: g0 = 1, g1 = 1; then x = [1,0]: second pair g0 = 0^0^0=0?
    assert list(cp.conv_encode([1])) == [1, 1]
    # zeros stay zeros (linear code)
    assert list(cp.conv_encode([0] * 8)) == [0] * 16


def test_conv_encode_matches_bit_recurrence():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2, 50).astype(np.uint8)
    coded = cp.conv_encode(x)
    # re-derive with the explicit shift-register loop
    sr = 0
    ref = []
    for b in x:
        window = ((int(b) & 1) << 4) | sr
        ref.append(bin(window & 0b10101).count("1") & 1)
        ref.append(bin(window & 0b10011).count("1") & 1)
        sr = (sr >> 1) | ((int(b) & 1) << 3)
    assert list(coded) == ref


def test_viterbi_hard_roundtrip():
    rng = np.random.default_rng(1)
    bits = rng.integers(0, 2, 200).astype(np.uint8)
    dec = cp.viterbi_decode_hard(cp.conv_encode(bits))
    assert np.array_equal(dec, bits)


def test_viterbi_soft_noisy():
    rng = np.random.default_rng(2)
    bits = rng.integers(0, 2, 300).astype(np.uint8)
    coded = cp.conv_encode(bits)
    d = cp.DQPSK_EXP[coded[0::2] * 2 + coded[1::2]]
    d = d + 0.4 * (rng.standard_normal(len(d)) + 1j * rng.standard_normal(len(d)))
    pairs = np.stack([d.real, d.imag], -1).astype(np.float32)
    dec = np.asarray(cp.viterbi_decode(pairs))
    assert np.array_equal(dec, bits)


def test_streaming_viterbi_matches_batch():
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, 120).astype(np.uint8)
    coded = cp.conv_encode(bits)
    d = cp.DQPSK_EXP[coded[0::2] * 2 + coded[1::2]]
    d = d + 0.2 * (rng.standard_normal(len(d)) + 1j * rng.standard_normal(len(d)))
    sv = cp.StreamingViterbi()
    out = []
    for z in d:
        b = sv.feed_symbol(float(z.real), float(z.imag))
        if b is not None:
            out.append(b)
    out.extend(sv.flush())
    assert np.array_equal(np.asarray(out[:len(bits)], np.uint8), bits)


# ── mod/demod ────────────────────────────────────────────────────────────────

def test_bpsk31_noiseless_bit_exact():
    rng = np.random.default_rng(4)
    bits = rng.integers(0, 2, 100).astype(np.uint8)
    iq, _ = bpsk31_mod_bits(bits, FS)
    soft = np.asarray(bpsk31_demod(iq, FS))
    assert np.array_equal(bpsk31_decide(soft), bits)


def test_bpsk31_sps():
    assert psk31_sps(8000.0) == 256
    assert psk31_sps(12000.0) == 384


def test_qpsk31_noiseless_text():
    msg = "KA1ABC de N0XYZ"
    iq = qpsk31_mod_text(msg, FS)
    st = Psk31Stream.new_qpsk(FS)
    text = st.feed(np.asarray(iq)) + st.flush()
    assert msg in text


def test_bpsk31_text_roundtrip_rf():
    msg = "CQ CQ de GPU1"
    iq = bpsk31_mod_text(msg, FS, rf_hz=1000.0)
    st = Psk31Stream.new_bpsk(FS, carrier_hz=1000.0)
    text = st.feed(np.asarray(iq)) + st.flush()
    assert msg in text


def test_psk31_stream_chunk_invariance():
    msg = "chunk boundary invariance"
    iq = np.asarray(bpsk31_mod_text(msg, FS, rf_hz=800.0))
    one = Psk31Stream.new_bpsk(FS, 800.0)
    t_one = one.feed(iq) + one.flush()
    chunked = Psk31Stream.new_bpsk(FS, 800.0)
    t_chunks = ""
    for i in range(0, len(iq), 777):
        t_chunks += chunked.feed(iq[i:i + 777])
    t_chunks += chunked.flush()
    assert t_one == t_chunks
    assert msg in t_chunks


def test_qpsk31_afc_tracks_cfo():
    msg = "afc test msg"
    iq = np.asarray(qpsk31_mod_text(msg, FS, rf_hz=1000.0))
    st = Psk31Stream.new_qpsk(FS, carrier_hz=1001.5)   # 1.5 Hz off
    text = st.feed(iq) + st.flush()
    assert msg in text


# ── SNR floors (reference: 100% @ −5 dB BPSK31, −6 dB QPSK31 in 2500 Hz) ────

@pytest.mark.parametrize("qpsk,snr_db", [(False, -5.0), (True, -6.0)])
def test_psk31_decode_at_snr_floor(qpsk, snr_db):
    msg = "CQ TEST"
    mod = qpsk31_mod_text if qpsk else bpsk31_mod_text
    carrier = 993.75
    iq = np.asarray(mod(msg, FS, rf_hz=carrier, preamble_bits=64))
    power = snr_to_noise_power(snr_db)
    ok = 0
    trials = 5
    for seed in range(trials):
        rng = np.random.default_rng(1000 + seed)
        noisy = iq + _awgn(rng, len(iq), power)
        st = Psk31Stream.new_qpsk(FS, carrier) if qpsk else \
            Psk31Stream.new_bpsk(FS, carrier)
        text = st.feed(noisy) + st.flush()
        ok += msg in text
    assert ok == trials, f"{ok}/{trials} decoded at {snr_db} dB"


# ── sync ─────────────────────────────────────────────────────────────────────

def test_waterfall_tone_peak():
    sps = 256
    n_syms, n_tones = 10, 8
    t = np.arange(n_syms * sps) / FS
    f = 500.0 + 3 * PSK31_BAUD
    iq = np.exp(2j * np.pi * f * t).astype(np.complex64)
    wf = np.asarray(compute_waterfall(iq, FS, 500.0, PSK31_BAUD, sps,
                                      n_syms, n_tones))
    assert wf.shape == (n_syms, n_tones)
    assert np.all(np.argmax(wf, axis=1) == 3)


def test_waterfall_past_buffer_rows_zero():
    iq = np.ones(256, np.complex64)
    wf = np.asarray(compute_waterfall(iq, FS, 500.0, PSK31_BAUD, 256, 4, 4))
    assert np.all(wf[1:] == 0.0)


def test_psk31_sync_finds_bpsk31():
    # ref roundtrip_psk31_sync_finds_bpsk31 (tests/roundtrip/psk31.rs:249)
    base_hz = 900.0
    carrier = base_hz + 3 * PSK31_BAUD
    iq = np.asarray(bpsk31_mod_text("CQ CQ", FS, rf_hz=carrier,
                                    preamble_bits=64))
    buf = np.zeros(max(int(FS * 4), len(iq)) + int(FS), np.complex64)
    buf[:len(iq)] = iq
    res = psk31_sync(buf, FS, base_hz, base_hz + 200.0, 4, 3.0, 256, 5)
    assert res
    assert abs(res[0].carrier_hz - carrier) < 40.0
    assert len(res[0].soft_bits) > 0


def test_psk31_sync_decodes_from_found_carrier():
    base_hz = 900.0
    carrier = base_hz + 3 * PSK31_BAUD
    msg = "CQ TEST"
    iq = np.asarray(bpsk31_mod_text(msg, FS, rf_hz=carrier, preamble_bits=64))
    rng = np.random.default_rng(7)
    buf = np.concatenate([iq, np.zeros(int(FS), np.complex64)])
    buf += _awgn(rng, len(buf), snr_to_noise_power(-5.0))
    res = psk31_sync(buf, FS, base_hz, base_hz + 200.0, 4, 3.0, 32, 5)
    assert res and abs(res[0].carrier_hz - carrier) < 40.0
    soft = np.asarray(bpsk31_demod(buf[:len(iq)], FS, res[0].carrier_hz, 1.0))
    text = vc.decode_bits(bpsk31_decide(soft))
    assert msg in text


def test_best_sync_picks_earliest_near_carrier():
    # ref tests/unit/psk31.rs:440
    mk = lambda hz, sym: Psk31SyncResult(sym, 0, hz, 1.0, np.zeros(0))
    res = [mk(1100.0, 2), mk(1000.0, 10), mk(1010.0, 5)]
    hz, sym = best_sync(res, 1000.0, PSK31_BAUD)
    assert (hz, sym) == (1010.0, 5)   # 1100 is >2·baud away; earliest wins


def test_best_sync_none_when_no_match():
    mk = lambda hz, sym: Psk31SyncResult(sym, 0, hz, 1.0, np.zeros(0))
    assert best_sync([mk(2000.0, 0)], 1000.0, PSK31_BAUD) is None
    assert best_sync([], 1000.0, PSK31_BAUD) is None


# ── whole-band multi-carrier decode (beyond-reference) ───────────────────────

def test_psk31_band_decode_three_carriers():
    """psk31_decode_band decodes every transmission in a band in one batched
    device pass (beyond-reference: the ref stack is one carrier/receiver).
    Carriers sit OFF the waterfall grid (+12.5 Hz) and start at arbitrary
    sample offsets — the squared-spectrum carrier refinement and the
    matched-filter timing search must both land for any text to decode."""
    from orion_sdr_tpu.codec.psk31_stream import psk31_decode_band
    base_hz = 900.0
    msgs = {base_hz + 4 * PSK31_BAUD + 12.5: "CQ DX ALPHA",
            base_hz + 12 * PSK31_BAUD + 12.5: "HELLO BAND",
            base_hz + 22 * PSK31_BAUD + 12.5: "TEST 73"}
    amps = [1.0, 0.4, 0.15]
    n = int(FS * 6)
    buf = np.zeros(n, np.complex64)
    rng = np.random.default_rng(21)
    for (hz, msg), a in zip(msgs.items(), amps):
        iq = a * np.asarray(bpsk31_mod_text(msg, FS, rf_hz=hz,
                                            preamble_bits=64))
        start = int(rng.integers(0, FS // 4))
        buf[start:start + len(iq)] += iq[: n - start]
    buf += _awgn(rng, n, 1e-4)
    got = psk31_decode_band(buf, FS, base_hz, base_hz + 30 * PSK31_BAUD)
    assert len(got) == 3
    assert got[0].score >= got[-1].score          # strongest first
    for hz, msg in msgs.items():
        near = [r for r in got if abs(r.carrier_hz - hz) < 40.0]
        assert near and msg in near[0].text, (hz, msg, got)


def test_psk31_band_decode_qpsk_smoke():
    from orion_sdr_tpu.codec.psk31_stream import psk31_decode_band
    base_hz = 900.0
    hz = base_hz + 6 * PSK31_BAUD
    iq = np.asarray(qpsk31_mod_text("QPSK BAND", FS, rf_hz=hz,
                                    preamble_bits=64))
    buf = np.concatenate([iq, np.zeros(int(FS), np.complex64)])
    got = psk31_decode_band(buf, FS, base_hz, base_hz + 200.0, qpsk=True)
    assert got and abs(got[0].carrier_hz - hz) < 40.0
    assert "QPSK BAND" in got[0].text


def test_psk31_band_decode_silence_empty():
    from orion_sdr_tpu.codec.psk31_stream import psk31_decode_band
    assert psk31_decode_band(np.zeros(int(FS * 2), np.complex64),
                             FS, 900.0, 1500.0) == []
    assert psk31_decode_band(np.zeros(0, np.complex64),
                             FS, 900.0, 1500.0) == []


def test_psk31_refine_carriers_offgrid():
    """Squared-spectrum refinement recovers carriers to sub-Hz from
    waterfall-bin-granular estimates (up to ±baud/2 off)."""
    from orion_sdr_tpu.demodulate.psk31 import psk31_refine_carriers
    true_hz = 1012.5 + 13.7
    iq = np.asarray(bpsk31_mod_text("REFINE", FS, rf_hz=true_hz,
                                    preamble_bits=48))
    coarse = np.asarray([1012.5], np.float32)      # 13.7 Hz off
    got = float(np.asarray(psk31_refine_carriers(iq, FS, coarse))[0])
    assert abs(got - true_hz) < 0.5
