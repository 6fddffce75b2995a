"""Receiver input-hygiene regressions: NaN bursts, silence, and
silence→signal transitions must never wedge a stream receiver, produce a
false decode, or lose the next genuine frame."""

import numpy as np
import pytest

import orion_sdr_tpu as sdr


def test_ft8_stream_rejects_nan_and_silence():
    dec = sdr.Ft8StreamDecoder.new_ft8(12000.0, 950.0, 1150.0)
    assert dec.feed(np.full(152000, np.nan + 1j * np.nan, np.complex64)) == []
    dec.clear()
    assert dec.feed(np.zeros(152000, np.complex64)) == []
    dec.clear()
    p = sdr.pack77(sdr.Ft8Standard("CQ", "KA1ABC", "FN42"), dec.hash_table)
    iq = np.asarray(sdr.ft8_mod(sdr.ft8_encode(p), 12000.0, base_hz=1012.5))
    res = dec.feed(iq)
    assert res and res[0].message.call_de == "KA1ABC"


def test_ft8_windows_silence_is_none():
    out = sdr.ft8_decode_windows(np.zeros((2, 151680), np.complex64),
                                 12000.0, 950.0, 1150.0)
    assert out == [None, None]


def test_dvb_t_stream_survives_nan_burst_then_frame():
    link = sdr.DvbTLinkParams(guard="1/32", constellation="qpsk",
                              code_rate="1/2")
    params = sdr.DvbTFrameParams(link, 0, 3)
    pl = b"recovery after NaN burst " * 4
    frame = sdr.DvbTFrameMod(params).modulate(pl)
    rx = sdr.DvbTFrameStreamDemod(params, frame.n_symbols, len(pl))
    got = rx.feed(np.full(100000, np.nan + 1j * np.nan, np.complex64))
    got += rx.feed(np.asarray(frame.iq))
    got += rx.feed(np.zeros(frame.samples_per_symbol * 2, np.complex64))
    got += rx.flush()
    assert any(hasattr(g, "payload") and bytes(g.payload) == pl for g in got)
    # none of the emitted items may be a false FRAME
    frames = [g for g in got if hasattr(g, "payload")]
    assert len(frames) == 1


def test_dvb_t_stream_silence_buffer_bounded():
    link = sdr.DvbTLinkParams(guard="1/32", constellation="qpsk",
                              code_rate="1/2")
    params = sdr.DvbTFrameParams(link, 0, 0)
    rx = sdr.DvbTFrameStreamDemod(params, 68, 100)
    for _ in range(4):
        assert rx.feed(np.zeros(200000, np.complex64)) == []
    assert len(rx) < 200000          # trimmed, not accumulating


def test_ofdm_stream_survives_nan_burst_then_frame():
    from orion_sdr_tpu.multicarrier import CarrierPlan
    from orion_sdr_tpu.ofdm import OfdmConfig
    from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble
    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = OfdmConfig(plan, fs=1e6)
    pre = OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = sdr.McsTable.default_ladder()
    p = np.random.default_rng(0).integers(0, 256, 80).astype(np.uint8)
    iq = sdr.OfdmFrameMod(cfg, table, pre).modulate_frame(
        sdr.FramePacket(sdr.FrameMetadata(1, 1), p), 0)
    srx = sdr.OfdmFrameStreamDemod(cfg, table, pre)
    got = srx.feed(np.full(40000, np.nan + 1j * np.nan, np.complex64))
    got += srx.feed(np.asarray(iq))
    got += srx.flush()
    assert any(hasattr(g, "packet") and np.array_equal(g.packet.payload, p)
               for g in got)


def test_gi_sync_silence_returns_none():
    from orion_sdr_tpu.sync.dvb_t_gi_sync import dvb_t_gi_sync
    assert dvb_t_gi_sync(np.zeros(50000, np.complex64), 2048, 64, 2.3e6,
                         2112) is None


def test_ts_depacketize_validates_sync_bytes():
    from orion_sdr_tpu.waveform.dvb_t_ts import ts_packetize, ts_depacketize
    pk = ts_packetize(np.arange(100, dtype=np.uint8))
    assert ts_depacketize(pk) is not None
    bad = pk.copy()
    bad[0] = 0x00
    assert ts_depacketize(bad) is None


def test_dvb_t_stream_soak_frames_through_noise_gaps():
    """Production streaming: frames separated by odd-length noise gaps must
    ALL decode, including the last one at flush (no look-ahead available)."""
    rng = np.random.default_rng(0)
    link = sdr.DvbTLinkParams(guard="1/32", constellation="qpsk",
                              code_rate="1/2")
    payloads, pieces = [], []
    n_sym = None
    for i in range(4):
        params = sdr.DvbTFrameParams(link, i % 4, 10 + i)
        pl = bytes(rng.integers(0, 256, 150).astype(np.uint8))
        f = sdr.DvbTFrameMod(params).modulate(pl)
        n_sym = f.n_symbols
        payloads.append(pl)
        gap = (rng.standard_normal(5000 + 1237 * i) * 0.01
               ).astype(np.complex64)
        pieces += [gap, np.asarray(f.iq)]
    pieces.append(np.zeros(4300, np.complex64))
    run = np.concatenate(pieces)
    rx = sdr.DvbTFrameStreamDemod(sdr.DvbTFrameParams(link, 0, 10), n_sym,
                                  150)
    got = []
    for chunk in np.array_split(run, 23):
        got += rx.feed(chunk)
    got += rx.flush()
    frames = [g for g in got if hasattr(g, "payload")]
    assert len(frames) == 4
    assert [g.tps.cell_id for g in frames] == [10, 11, 12, 13]
    assert all(bytes(fr.payload) == p for fr, p in zip(frames, payloads))


def test_ofdm_stream_noise_buffer_bounded_and_straddle_recovers():
    from orion_sdr_tpu.multicarrier import CarrierPlan
    from orion_sdr_tpu.ofdm import OfdmConfig
    from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble
    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = OfdmConfig(plan, fs=1e6)
    pre = OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        256, 64)
    table = sdr.McsTable.default_ladder()
    rx = sdr.OfdmFrameStreamDemod(cfg, table, pre)
    rng = np.random.default_rng(0)
    for _ in range(5):
        rx.feed((rng.standard_normal(200000) +
                 1j * rng.standard_normal(200000)
                 ).astype(np.complex64) * 0.1)
    assert len(rx) < 10000            # trimmed, not accumulating
    p = rng.integers(0, 256, 90).astype(np.uint8)
    iq = np.asarray(sdr.OfdmFrameMod(cfg, table, pre).modulate_frame(
        sdr.FramePacket(sdr.FrameMetadata(2, 1), p), 0))
    got = rx.feed(iq[:300]) + rx.feed(iq[300:]) + rx.flush()
    assert any(hasattr(g, "packet") and np.array_equal(g.packet.payload, p)
               for g in got)


def test_psk31_stream_nan_then_text():
    s = sdr.Psk31Stream.new_bpsk(8000.0)
    assert s.feed(np.full(60000, np.nan + 1j * np.nan, np.complex64)) == ""
    iq = np.asarray(sdr.bpsk31_mod_text("CQ CQ DE K5GPU", 8000.0))
    text = s.feed(iq) + s.feed(np.zeros(4000, np.complex64))
    assert "CQ CQ DE K5GPU" in text


def test_new_mode_receivers_handle_silence_and_tiny_inputs():
    """Every new-mode receiver returns empty/None (or a documented
    ValueError) on silence and on captures shorter than one frame —
    never an unhandled crash."""
    import orion_sdr_tpu as sdr
    import numpy as np
    silence = np.zeros(60_000, np.complex64)
    tiny = np.zeros(64, np.complex64)

    assert sdr.pocsag_decode(silence, 38_400.0) == []
    assert sdr.pocsag_decode(tiny, 38_400.0) == []
    assert sdr.ais_decode(silence, 96_000.0) == []
    assert sdr.ais_decode(tiny, 96_000.0) == []
    assert sdr.adsb_decode_capture(silence, 8_000_000.0) == []
    assert sdr.css_demod(silence, sf=7) is None
    assert sdr.css_demod(tiny, sf=7) is None
    assert sdr.wspr_demod(silence) is None
    assert sdr.ax25_decode(np.zeros(60_000, np.float32), 48_000.0) == []
    assert sdr.rtty_decode(np.zeros(60_000, np.float32), 11_025.0) == ""
    assert sdr.rds_decode_bits(np.zeros(50, np.uint8)).pi is None
    out = sdr.fm_stereo_demod(silence[:1 << 15], 240_000.0,
                              decode_rds=True)
    assert out.pilot_level < 0.01
    bands = sdr.band_decode(
        (np.random.default_rng(0).standard_normal(1 << 16)
         + 1j * np.random.default_rng(1).standard_normal(1 << 16)
         ).astype(np.complex64) * 1e-3, 500_000.0)
    assert isinstance(bands, list)
