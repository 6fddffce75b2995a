"""FT8/FT4 stack tests — mirrors reference tests/unit/{ft8,ft4,message}.rs +
roundtrip/ft8.rs + performance/snr thresholds (FT8 −15 dB, FT4 −11 dB)."""

import numpy as np
import pytest

from orion_sdr_tpu.codec import ft8_crc, ft8_ldpc, gray
from orion_sdr_tpu.codec.ft8 import (
    ft8_encode, ft4_encode, ft8_decode_hard, ft4_decode_hard,
    ft8_decode_soft, ft4_decode_soft, ft8_frame_llr_hard, ft4_frame_llr_hard,
)
from orion_sdr_tpu.codec.ft8_stream import Ft8StreamDecoder
from orion_sdr_tpu.message import (
    pack77, unpack77, CallsignHashTable, Standard, FreeText, Telemetry,
    NonStd, hash22, packgrid, unpackgrid,
)
from orion_sdr_tpu.modulate.ft8 import (
    ft8_mod, ft4_mod, ft8_symbol_sequence, ft4_symbol_sequence,
    FT8_FRAME_LEN, FT4_FRAME_LEN, FT8_COSTAS,
)
from orion_sdr_tpu.demodulate.ft8 import ft8_demod, ft4_demod
from orion_sdr_tpu.sync.ft8_sync import ft8_sync, ft4_sync

FS = 12000.0


def _rand_payload(seed=0):
    rng = np.random.default_rng(seed)
    p = rng.integers(0, 256, 10).astype(np.uint8)
    p[9] &= 0xF8
    return p


def _awgn(rng, n, power):
    return ((rng.standard_normal(n) + 1j * rng.standard_normal(n))
            * np.sqrt(power / 2)).astype(np.complex64)


def snr_to_noise_power(snr_db, fs=FS, ref_bw=2500.0):
    return fs / (ref_bw * 10.0 ** (snr_db / 10.0))


# ── crc14 ────────────────────────────────────────────────────────────────────

def test_crc14_all_ones_payload():
    # byte 9 slack: 77 ones → byte 9 = 0xF8 (ref codec/crc.rs:22-26)
    payload = np.full(10, 0xFF, np.uint8)
    a91 = ft8_crc.ft8_add_crc(payload)
    assert a91[9] & 0xF8 == 0xF8
    assert ft8_crc.ft8_check_crc(a91)


def test_crc14_detects_bit_error():
    a91 = ft8_crc.ft8_add_crc(_rand_payload(1))
    assert ft8_crc.ft8_check_crc(a91)
    bad = a91.copy()
    bad[3] ^= 0x10
    assert not ft8_crc.ft8_check_crc(bad)


# ── gray ─────────────────────────────────────────────────────────────────────

def test_gray_maps_are_inverses():
    for i in range(8):
        assert gray.gray8_decode(gray.gray8_encode(i)) == i
    for i in range(4):
        assert gray.gray4_decode(gray.gray4_encode(i)) == i
    assert list(gray.FT8_GRAY) == [0, 1, 3, 2, 5, 6, 4, 7]


# ── ldpc(174,91) ─────────────────────────────────────────────────────────────

def test_ldpc174_encode_valid_codeword():
    rng = np.random.default_rng(2)
    msg = rng.integers(0, 2, 91).astype(np.uint8)
    cw = np.asarray(ft8_ldpc.ldpc_encode(msg))
    assert cw.shape == (174,)
    assert np.array_equal(cw[:91], msg)          # systematic
    assert ft8_ldpc.ldpc_count_errors(cw) == 0


def test_ldpc174_corrects_flips():
    rng = np.random.default_rng(3)
    msg = rng.integers(0, 2, 91).astype(np.uint8)
    cw = np.asarray(ft8_ldpc.ldpc_encode(msg))
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    llr[rng.choice(174, 8, replace=False)] *= -1
    bits, errs = ft8_ldpc.ldpc_decode_soft(llr)
    assert int(errs) == 0
    assert np.array_equal(np.asarray(bits), msg)


# ── message layer ────────────────────────────────────────────────────────────

def test_message_standard_roundtrips():
    ht = CallsignHashTable()
    cases = [
        Standard("CQ", "KA1ABC", "FN42"),
        Standard("KA1ABC", "W9XYZ", "-12"),
        Standard("W9XYZ", "KA1ABC", "R+03"),
        Standard("KA1ABC", "W9XYZ", "RR73"),
        Standard("K1ABC/R", "W9XYZ/R", "FN42"),
        Standard("CQ TEST", "K1ABC", "FN42"),
        Standard("CQ 013", "K1ABC", ""),
    ]
    for msg in cases:
        out = unpack77(pack77(msg, ht), ht)
        assert (out.call_to, out.call_de, out.extra) == \
            (msg.call_to, msg.call_de, msg.extra)


def test_message_free_text_and_telemetry():
    ht = CallsignHashTable()
    out = unpack77(pack77(FreeText("TNX BOB 73 GL"), ht), ht)
    assert out.text == "TNX BOB 73 GL"
    data = np.frombuffer(bytes.fromhex("123456789abcdef012"), np.uint8).copy()
    out = unpack77(pack77(Telemetry(data), ht), ht)
    assert np.array_equal(out.data, data & np.array([0x7F] + [0xFF] * 8, np.uint8))


def test_message_nonstd_with_hash():
    ht = CallsignHashTable()
    out = unpack77(pack77(NonStd("CQ", "PJ4/K1ABC"), ht), ht)
    assert out.call_to == "CQ" and out.call_de == "PJ4/K1ABC"
    out = unpack77(pack77(NonStd("W9XYZ", "PJ4/K1ABC", "RR73"), ht), ht)
    assert out.call_de == "PJ4/K1ABC" and out.call_to == "<W9XYZ>"
    assert out.extra == "RR73"


def test_hash22_deterministic():
    assert hash22("KA1ABC") == hash22("KA1ABC")
    assert hash22("KA1ABC") != hash22("W9XYZ")
    assert hash22("KA1ABC") < (1 << 22)


def test_grid_pack_unpack():
    for extra in ["FN31", "AA00", "RR99", "+07", "-24", "R-12", "RRR",
                  "RR73", "73", ""]:
        ig, ir = packgrid(extra)
        assert unpackgrid(ig, ir) == extra, extra


# ── codec ────────────────────────────────────────────────────────────────────

def test_ft8_codec_roundtrip():
    p = _rand_payload(4)
    tones = ft8_encode(p)
    assert tones.shape == (58,) and tones.max() <= 7
    assert np.array_equal(ft8_decode_hard(tones), p)


def test_ft4_codec_roundtrip_with_scramble():
    p = _rand_payload(5)
    tones = ft4_encode(p)
    assert tones.shape == (87,) and tones.max() <= 3
    assert np.array_equal(ft4_decode_hard(tones), p)


def test_ft8_codec_rejects_garbage():
    p = _rand_payload(6)
    bad = (ft8_encode(p) + 1) % 8
    assert ft8_decode_soft(ft8_frame_llr_hard(bad)) is None


# ── mod/demod ────────────────────────────────────────────────────────────────

def test_ft8_symbol_sequence_costas():
    seq = ft8_symbol_sequence(np.arange(58) % 8)
    assert len(seq) == 79
    for s in (0, 36, 72):
        assert np.array_equal(seq[s:s + 7], FT8_COSTAS)


def test_ft8_mod_constants_and_phase_continuity():
    iq = np.asarray(ft8_mod(np.zeros(58, np.uint8), FS, 1000.0))
    assert len(iq) == FT8_FRAME_LEN == 151_680
    assert np.allclose(np.abs(iq), 1.0, atol=1e-4)
    d = np.abs(np.diff(np.angle(iq)))
    d = np.minimum(d, 2 * np.pi - d)
    assert d.max() < 2 * np.pi * (1000.0 + 7 * 6.25) / FS + 1e-3


def test_ft8_mod_demod_bit_exact():
    rng = np.random.default_rng(7)
    tones = rng.integers(0, 8, 58).astype(np.uint8)
    rx = ft8_demod(ft8_mod(tones, FS, 1000.0), FS, 1000.0)
    assert np.array_equal(rx, tones)


def test_ft4_mod_demod_bit_exact():
    rng = np.random.default_rng(8)
    tones = rng.integers(0, 4, 87).astype(np.uint8)
    iq = ft4_mod(tones, FS, 1000.0)
    assert np.shape(iq)[-1] == FT4_FRAME_LEN == 60_480
    assert np.array_equal(ft4_demod(iq, FS, 1000.0), tones)


def test_ft8_demod_short_input_none():
    assert ft8_demod(np.zeros(100, np.complex64)) is None


# ── sync + end-to-end SNR floors ─────────────────────────────────────────────

def test_ft8_sync_finds_frame():
    ht = CallsignHashTable()
    p = pack77(Standard("CQ", "KA1ABC", "FN42"), ht)
    base = 1000.0 + 3 * 6.25
    iq = np.asarray(ft8_mod(ft8_encode(p), FS, base_hz=base))
    res = ft8_sync(iq, FS, 1000.0, 1100.0, 0, 0, 4)
    assert res and res[0].freq_bin == 3 and res[0].time_sym == 0
    payload = ft8_decode_soft(res[0].llr)
    assert payload is not None and np.array_equal(payload, p)


@pytest.mark.parametrize("ft8,snr_db", [(True, -15.0), (False, -11.0)])
def test_ftx_decode_at_snr_floor(ft8, snr_db):
    ht = CallsignHashTable()
    p = pack77(Standard("CQ", "KA1ABC", "FN42"), ht)
    base = 1012.5
    if ft8:
        iq = np.asarray(ft8_mod(ft8_encode(p), FS, base_hz=base))
        mk = Ft8StreamDecoder.new_ft8
    else:
        iq = np.asarray(ft4_mod(ft4_encode(p), FS, base_hz=base))
        mk = Ft8StreamDecoder.new_ft4
    power = snr_to_noise_power(snr_db)
    trials, ok = 5, 0
    for seed in range(trials):
        rng = np.random.default_rng(2000 + seed)
        dec = mk(FS, 950.0, 1150.0, max_cand=4)
        res = dec.feed(iq + _awgn(rng, len(iq), power))
        ok += bool(res and res[0].message.call_de == "KA1ABC"
                   and res[0].message.extra == "FN42")
    assert ok == trials, f"{ok}/{trials} at {snr_db} dB"


def test_ft8_stream_decoder_hash_table_persists():
    dec = Ft8StreamDecoder.new_ft8(FS, 950.0, 1150.0)
    p1 = pack77(NonStd("CQ", "PJ4/K1ABC"), dec.hash_table)
    res = dec.feed(np.asarray(ft8_mod(ft8_encode(p1), FS, base_hz=1012.5)))
    assert res and res[0].message.call_de == "PJ4/K1ABC"
    dec.clear()
    ht2 = CallsignHashTable()
    p2 = pack77(NonStd("PJ4/K1ABC", "W9XYZ"), ht2)  # call_to hashed
    # lower-level check: hash resolution through the decoder's table
    msg = unpack77(p2, dec.hash_table)
    assert msg.call_to == "<PJ4/K1ABC>"


def test_ft8_decode_windows_batched():
    """BASELINE config 3: many 15 s windows, one batched LDPC pass."""
    from orion_sdr_tpu.codec.ft8_stream import ft8_decode_windows
    ht = CallsignHashTable()
    calls = ("KA1ABC", "W9XYZ", "K5GPU")
    rng = np.random.default_rng(31)
    wins = []
    for i, c in enumerate(calls):
        p = pack77(Standard("CQ", c, "FN42"), ht)
        iq = np.asarray(ft8_mod(ft8_encode(p), FS, base_hz=1000.0 + i * 25))
        iq = iq + _awgn(rng, len(iq), snr_to_noise_power(-12.0))
        wins.append(iq)
    # one empty window: must come back None, not a false decode
    wins.append(_awgn(rng, len(wins[0]), snr_to_noise_power(-12.0)))
    out = ft8_decode_windows(np.stack(wins), FS, 950.0, 1150.0,
                             hash_table=ht)
    assert [o.message.call_de if o else None for o in out] == \
        list(calls) + [None]


def test_ft4_decode_windows_batched():
    from orion_sdr_tpu.codec.ft8_stream import ft4_decode_windows
    ht = CallsignHashTable()
    calls = ("KA1ABC", "W9XYZ")
    rng = np.random.default_rng(33)
    wins = []
    for i, c in enumerate(calls):
        p = pack77(Standard("CQ", c, "FN42"), ht)
        iq = np.asarray(ft4_mod(ft4_encode(p), FS, base_hz=1000.0 + i * 30))
        iq = iq + _awgn(rng, len(iq), snr_to_noise_power(-8.0))
        wins.append(iq)
    wins.append(_awgn(rng, len(wins[0]), snr_to_noise_power(-8.0)))
    out = ft4_decode_windows(np.stack(wins), FS, 950.0, 1150.0,
                             hash_table=ht)
    assert [o.message.call_de if o else None for o in out] == \
        list(calls) + [None]


def test_ft8_mod_batch_matches_scalar():
    """Batched runtime-tones TX == the trace-time-constant path (round-3
    TX tier: no per-message recompile)."""
    from orion_sdr_tpu.modulate.ft8 import ft8_mod, ft8_mod_batch
    rng = np.random.default_rng(0)
    tones = rng.integers(0, 8, (3, 58)).astype(np.uint8)
    batch = np.asarray(ft8_mod_batch(tones))
    for i in range(3):
        ref = np.asarray(ft8_mod(tones[i]))
        assert batch.shape[-1] == ref.shape[-1]
        np.testing.assert_allclose(batch[i], ref, atol=2e-3)


def test_ft4_mod_batch_matches_scalar():
    from orion_sdr_tpu.modulate.ft8 import ft4_mod, ft4_mod_batch
    rng = np.random.default_rng(1)
    tones = rng.integers(0, 4, (2, 87)).astype(np.uint8)
    batch = np.asarray(ft4_mod_batch(tones))
    for i in range(2):
        ref = np.asarray(ft4_mod(tones[i]))
        np.testing.assert_allclose(batch[i], ref, atol=2e-3)


def test_ft8_mod_batch_roundtrips_through_demod():
    from orion_sdr_tpu.modulate.ft8 import ft8_mod_batch
    from orion_sdr_tpu.demodulate.ft8 import ft8_demod
    rng = np.random.default_rng(2)
    tones = rng.integers(0, 8, 58).astype(np.uint8)
    iq = np.asarray(ft8_mod_batch(tones[None]))[0]
    got = np.asarray(ft8_demod(iq))
    assert np.array_equal(got, tones)


def test_ft8_multi_frame_decode_combines_repeats():
    """Multi-frame averaging (beyond-reference): a message too noisy for
    any single frame decodes from the summed-LLR combination of repeats."""
    from orion_sdr_tpu.modulate.ft8 import ft8_mod
    from orion_sdr_tpu.codec.ft8 import ft8_encode
    from orion_sdr_tpu.codec.ft8_stream import (Ft8StreamDecoder,
                                                ft8_decode_multi_frame)
    from orion_sdr_tpu.message import pack77, Standard, CallsignHashTable
    fs = 12000.0
    p = pack77(Standard("CQ", "KA1ABC", "FN42"), CallsignHashTable())
    iq = np.asarray(ft8_mod(ft8_encode(p), fs, base_hz=1012.5))
    rng = np.random.default_rng(101)
    power = fs / (2500.0 * 10.0 ** (-21.0 / 10.0))   # −21 dB in 2500 Hz BW
    frames = np.stack([
        iq + ((rng.standard_normal(len(iq))
               + 1j * rng.standard_normal(len(iq)))
              * np.sqrt(power / 2)).astype(np.complex64)
        for _ in range(4)])
    # single-frame path fails well below the reference's −15 dB floor
    single = Ft8StreamDecoder.new_ft8(fs, 950.0, 1150.0).feed(frames[0])
    assert not (single and single[0].message.call_de == "KA1ABC")
    got = ft8_decode_multi_frame(frames, fs, 950.0, 1150.0)
    assert got is not None and got.message.call_de == "KA1ABC"


def test_ft4_multi_frame_decode_smoke():
    from orion_sdr_tpu.modulate.ft8 import ft4_mod
    from orion_sdr_tpu.codec.ft8 import ft4_encode
    from orion_sdr_tpu.codec.ft8_stream import ft4_decode_multi_frame
    from orion_sdr_tpu.message import pack77, Standard, CallsignHashTable
    fs = 12000.0
    p = pack77(Standard("CQ", "W9XYZ", "EN50"), CallsignHashTable())
    iq = np.asarray(ft4_mod(ft4_encode(p), fs, base_hz=1012.5))
    rng = np.random.default_rng(7)
    power = fs / (2500.0 * 10.0 ** (-14.0 / 10.0))
    frames = np.stack([
        iq + ((rng.standard_normal(len(iq))
               + 1j * rng.standard_normal(len(iq)))
              * np.sqrt(power / 2)).astype(np.complex64)
        for _ in range(4)])
    got = ft4_decode_multi_frame(frames, fs, 950.0, 1150.0)
    assert got is not None and got.message.call_de == "W9XYZ"


def _ft8_signal(msg_fields, fs, base_hz, amp=1.0):
    from orion_sdr_tpu.modulate.ft8 import ft8_mod
    from orion_sdr_tpu.codec.ft8 import ft8_encode
    from orion_sdr_tpu.message import pack77, Standard, CallsignHashTable
    p = pack77(Standard(*msg_fields), CallsignHashTable())
    return amp * np.asarray(ft8_mod(ft8_encode(p), fs, base_hz=base_hz))


def test_ft8_multi_signal_decodes_separated_band():
    """Multi-signal subtraction decode (beyond-reference; ref codec/ft8.rs
    returns only the first decode): every signal in a crowded band comes
    out, strongest first."""
    from orion_sdr_tpu.codec.ft8_stream import ft8_decode_multi_signal
    fs = 12000.0
    iq = (_ft8_signal(("CQ", "KA1ABC", "FN42"), fs, 1012.5, 1.0)
          + _ft8_signal(("KA1ABC", "W9XYZ", "EN50"), fs, 1293.75, 0.5)
          + _ft8_signal(("CQ", "G4ABC", "IO91"), fs, 1550.0, 0.25))
    rng = np.random.default_rng(11)
    iq = (iq + 0.05 * (rng.standard_normal(len(iq))
                       + 1j * rng.standard_normal(len(iq)))
          ).astype(np.complex64)
    got = ft8_decode_multi_signal(iq, fs, 950.0, 1700.0)
    calls = {r.message.call_de for r in got}
    assert {"KA1ABC", "W9XYZ", "G4ABC"} <= calls


def test_ft8_multi_signal_uncovers_cochannel_weak():
    """A weak co-channel time-aligned signal hidden under a strong one is
    only decodable after the strong frame is re-synthesized, LS-fitted, and
    subtracted (second pass via the revisit-cell mechanism)."""
    from orion_sdr_tpu.codec.ft8_stream import ft8_decode_multi_signal
    fs = 12000.0
    strong = _ft8_signal(("CQ", "KA1ABC", "FN42"), fs, 1012.5, 1.0)
    weak = _ft8_signal(("KA1ABC", "W9XYZ", "EN50"), fs, 1012.5, 0.12)
    rng = np.random.default_rng(12)
    iq = (strong + weak
          + 0.01 * (rng.standard_normal(len(strong))
                    + 1j * rng.standard_normal(len(strong)))
          ).astype(np.complex64)
    one_pass = ft8_decode_multi_signal(iq, fs, 950.0, 1150.0, max_passes=1)
    assert {r.message.call_de for r in one_pass} == {"KA1ABC"}
    got = ft8_decode_multi_signal(iq, fs, 950.0, 1150.0, max_passes=3)
    assert {r.message.call_de for r in got} == {"KA1ABC", "W9XYZ"}


def test_ft4_multi_signal_smoke():
    from orion_sdr_tpu.modulate.ft8 import ft4_mod
    from orion_sdr_tpu.codec.ft8 import ft4_encode
    from orion_sdr_tpu.codec.ft8_stream import ft4_decode_multi_signal
    from orion_sdr_tpu.message import pack77, Standard, CallsignHashTable
    fs = 12000.0
    ht = CallsignHashTable()
    a = np.asarray(ft4_mod(ft4_encode(pack77(
        Standard("CQ", "KA1ABC", "FN42"), ht)), fs, base_hz=1012.5))
    b = np.asarray(ft4_mod(ft4_encode(pack77(
        Standard("CQ", "W9XYZ", "EN50"), ht)), fs, base_hz=1300.0))
    iq = (a + 0.5 * b).astype(np.complex64)
    got = ft4_decode_multi_signal(iq, fs, 950.0, 1400.0)
    assert {r.message.call_de for r in got} == {"KA1ABC", "W9XYZ"}


# ── a-priori (AP) decoding (beyond-reference; WSJT-X's AP idea) ──────────────

def test_ap_prior_matches_packed_message():
    from orion_sdr_tpu.codec.ft8 import ft8_ap_prior
    ht = CallsignHashTable()
    p = pack77(Standard("CQ", "KA1ABC", "FN42"), ht)
    truth = np.unpackbits(np.asarray(p, np.uint8))[:77]
    idx, bits = ft8_ap_prior("CQ")
    assert np.array_equal(idx, np.arange(29))
    assert np.array_equal(bits, truth[:29])
    # second slot: the caller's own call
    idx2, bits2 = ft8_ap_prior(call_b="KA1ABC")
    assert np.array_equal(idx2, np.arange(29, 58))
    assert np.array_equal(bits2, truth[29:58])


def test_ap_decode_rescues_low_snr_frame():
    """Seeded −19.5 dB capture where the plain decode fails: the AP-primed
    retry recovers it, in both the stream and batched-window paths."""
    import orion_sdr_tpu as sdr
    p = pack77(Standard("CQ", "KA1ABC", "FN42"), CallsignHashTable())
    iq = np.asarray(ft8_mod(ft8_encode(p), FS, base_hz=1012.5))
    rng = np.random.default_rng(904)
    noise_p = FS / (2500.0 * 10.0 ** (-19.5 / 10.0))
    noisy = iq + (rng.standard_normal(len(iq)) +
                  1j * rng.standard_normal(len(iq))
                  ).astype(np.complex64) * np.sqrt(noise_p / 2)
    ap = sdr.ft8_ap_prior("CQ")

    plain = Ft8StreamDecoder.new_ft8(FS, 950.0, 1150.0).feed(noisy)
    assert not plain or plain[0].message.call_de != "KA1ABC"
    with_ap = Ft8StreamDecoder(FS, 950.0, 1150.0, ap=ap).feed(noisy)
    assert with_ap and with_ap[0].message.call_de == "KA1ABC"
    assert with_ap[0].message.call_to == "CQ"

    w = np.stack([noisy, np.zeros_like(noisy)])
    res = sdr.ft8_decode_windows(w, FS, 950.0, 1150.0, ap=ap)
    assert res[0] is not None and res[0].message.call_de == "KA1ABC"
    assert res[1] is None        # AP must not hallucinate from silence


def test_ap_decode_rejects_prior_mismatch():
    """An AP prior for the WRONG call must not fabricate a decode: the
    clamped bits contradict the signal, BP fails or the verification
    rejects it."""
    import orion_sdr_tpu as sdr
    p = pack77(Standard("W9XYZ", "KA1ABC", "FN42"), CallsignHashTable())
    iq = np.asarray(ft8_mod(ft8_encode(p), FS, base_hz=1012.5))
    rng = np.random.default_rng(5)
    noisy = iq + (rng.standard_normal(len(iq)) +
                  1j * rng.standard_normal(len(iq))
                  ).astype(np.complex64) * 0.05
    ap = sdr.ft8_ap_prior("CQ")          # wrong: message is to W9XYZ
    got = Ft8StreamDecoder(FS, 950.0, 1150.0, ap=ap).feed(noisy)
    # plain decode wins (tried first) and reports the true message
    assert got and got[0].message.call_to == "W9XYZ"
    # force the AP-only path: clamp on a clean LLR set and decode directly
    from orion_sdr_tpu.sync.ft8_sync import ft8_sync as _sync
    cand = _sync(noisy, FS, 950.0, 1150.0)[0]
    assert ft8_decode_soft(cand.llr, ap=ap) is None


def test_ap_decode_ft4_roundtrip():
    from orion_sdr_tpu.codec.ft8 import ft8_ap_prior
    import orion_sdr_tpu as sdr
    ht = CallsignHashTable()
    p = pack77(Standard("CQ", "K1ABC", "AA00"), ht)
    tones = ft4_encode(p)
    ap = ft8_ap_prior("CQ", ft4=True)
    llr = ft4_frame_llr_hard(tones)
    rng = np.random.default_rng(8)
    llr = llr + rng.normal(0, 6.0, llr.shape).astype(np.float32)
    out = ft4_decode_soft(llr, ap=ap)
    assert out is not None and np.array_equal(out, p)


def test_ap_multi_frame_composes():
    """AP prior + 4-frame LLR averaging decodes at −23 dB where the plain
    averaged decode fails (seeded) — the composed floor past WSJT-X's
    published −21 dB."""
    import orion_sdr_tpu as sdr
    p = pack77(Standard("CQ", "KA1ABC", "FN42"), CallsignHashTable())
    iq = np.asarray(ft8_mod(ft8_encode(p), FS, base_hz=1012.5))
    ap = sdr.ft8_ap_prior("CQ")
    rng = np.random.default_rng(601)    # seed where plain fails, AP decodes
    pwr = FS / (2500.0 * 10.0 ** (-23.0 / 10.0))
    frames = np.stack([iq + (rng.standard_normal(len(iq)) +
                             1j * rng.standard_normal(len(iq))
                             ).astype(np.complex64) * np.sqrt(pwr / 2)
                       for _ in range(4)])
    plain = sdr.ft8_decode_multi_frame(frames, FS, 950.0, 1150.0)
    assert plain is None or plain.message.call_de != "KA1ABC"
    got = sdr.ft8_decode_multi_frame(frames, FS, 950.0, 1150.0, ap=ap)
    assert got is not None and got.message.call_de == "KA1ABC"
