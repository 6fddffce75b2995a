"""DVB-T stack tests — mirrors reference tests/unit/dvb_t.rs (spec known
answers), unit/dvb_t_tps.rs, and roundtrip/dvb_t{,_stream}.rs capstones."""

import numpy as np
import pytest

from orion_sdr_tpu.waveform import dvb_t as D
from orion_sdr_tpu.waveform import dvb_t_tps as T
from orion_sdr_tpu.waveform import dvb_t_ts as TS
from orion_sdr_tpu.waveform.dvb_t import DvbTLinkParams, DvbTFrameParams
from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod, tx_lowpass_for_2k
from orion_sdr_tpu.demodulate.dvb_t_frame import DvbTFrameDemod, DvbTRxError
from orion_sdr_tpu.modulate.dvb_t_super_frame import (DvbTSuperFrameMod,
                                                      DvbTSuperFrameParams)
from orion_sdr_tpu.demodulate.dvb_t_super_frame import DvbTSuperFrameDemod
from orion_sdr_tpu.demodulate.dvb_t_stream import DvbTFrameStreamDemod
from orion_sdr_tpu.sync.dvb_t_gi_sync import (dvb_t_gi_sync, dvb_t_gi_refine,
                                              dvb_t_integer_cfo)
from orion_sdr_tpu.dsp.osc import rotate

LINK = DvbTLinkParams("1/32", "qpsk", "1/2")


def _payload(n, seed=0):
    return np.random.default_rng(seed).integers(0, 256, n).astype(np.uint8)


# ── spec known answers (ref tests/unit/dvb_t.rs) ─────────────────────────────

def test_energy_dispersal_first_byte():
    assert D.dvb_t_prbs_bytes(1)[0] == 0x03


def test_wk_prbs_prefix():
    wk = D.wk_prbs()
    assert list(wk[:13]) == [1] * 11 + [0, 0]
    assert len(wk) == 1705


def test_qam_known_points():
    s = D.axis_scale(2)
    assert abs(D.dvb_t_map_symbol([0, 0]) - (1 + 1j) * s) < 1e-6
    assert abs(D.dvb_t_map_symbol([1, 1]) - (-1 - 1j) * s) < 1e-6
    s16 = D.axis_scale(4)
    # 16-QAM y=(0,0,0,0) → I=table[00]=3, Q=3
    assert abs(D.dvb_t_map_symbol([0, 0, 0, 0]) - (3 + 3j) * s16) < 1e-6
    for v in (2, 4, 6):
        e = np.mean(np.abs(np.asarray(D._point_table(v))) ** 2)
        assert abs(e - 1.0) < 1e-5


def test_constellation_roundtrip_and_llr_sign():
    rng = np.random.default_rng(1)
    for v in (2, 4, 6):
        bits = rng.integers(0, 2, 60 * v).astype(np.uint8)
        syms = np.asarray(D.dvb_t_map_symbols(bits, v))
        assert np.array_equal(np.asarray(D.dvb_t_demap_symbols(syms, v)), bits)
        llr = np.asarray(D.dvb_t_soft_llrs(syms, v))
        assert np.array_equal((llr <= 0).astype(np.uint8), bits)


def test_numerology_constants():
    assert D.DVB_T_N_FFT == 2048 and D.DVB_T_KMAX == 1704
    assert D.DVB_T_DATA_CARRIERS == 1512
    assert len(D.DVB_T_CONTINUAL_PILOTS_2K) == 45
    assert len(D.DVB_T_TPS_CARRIERS_2K) == 17
    assert D.DVB_T_MAX_RX_WINDOW_BACKOFF == 85
    assert D.guard_cp_len_2k("1/32") == 64 and D.guard_cp_len_2k("1/4") == 512


def test_scattered_plans_1512_data():
    g = D.scattered_grid()
    for p in range(4):
        assert g.data_bins[p].shape == (1512,)
        # scattered indices satisfy k mod 12 == 3p
        sc = D.scattered_pilot_indices(p)
        assert np.all(sc % 12 == 3 * p)
        # TPS bins excluded from channel references
        assert not (set(np.asarray(g.ref_bins[p]).tolist())
                    & set(D.tps_carrier_bins().tolist()))


def test_scattered_map_extract_roundtrip():
    rng = np.random.default_rng(2)
    data = (rng.standard_normal((9, 1512)) +
            1j * rng.standard_normal((9, 1512))).astype(np.complex64)
    freq = D.scattered_map_frame(data)
    assert np.allclose(np.asarray(D.scattered_extract_frame(freq)), data)


def test_nb_bandwidth_scaling():
    assert abs(D.dvb_t_fs_for_bandwidth(1e6) - 2048e6 / 1705) < 1e-3
    assert abs(D.dvb_t_occupied_bw(D.DVB_T_FS_333KHZ) - 333e3) < 1e-3


# ── TS layer ─────────────────────────────────────────────────────────────────

def test_ts_packetize_disperse_roundtrip():
    payload = _payload(1000, 3)
    ts = TS.ts_packetize(payload)
    assert len(ts) % 188 == 0 and ts[0] == 0x47
    disp = TS.ts_energy_disperse(ts)
    assert disp[0] == 0xB8 and disp[188] == 0x47
    assert np.array_equal(TS.ts_energy_disperse(disp), ts)
    assert np.array_equal(TS.ts_depacketize(ts)[:1000], payload)


def test_ts_null_packet_header():
    pkt = TS.ts_null_packet()
    assert list(pkt[:4]) == [0x47, 0x1F, 0xFF, 0x10]
    assert np.all(pkt[4:] == 0xFF)


# ── TPS ──────────────────────────────────────────────────────────────────────

def test_tps_bch_corrects_two_errors():
    rng = np.random.default_rng(4)
    info = rng.integers(0, 2, 53).astype(np.uint8)
    cw = T.tps_bch_encode(info)
    assert np.array_equal(T.tps_bch_decode(cw), info)
    bad = cw.copy()
    bad[[5, 40]] ^= 1
    assert np.array_equal(T.tps_bch_decode(bad), info)
    bad3 = cw.copy()
    bad3[[1, 5, 9]] ^= 1
    assert T.tps_bch_decode(bad3) is None


def test_tps_word_roundtrip_all_fields():
    for fn in range(4):
        w = T.TpsWord(frame_number=fn, constellation="qam64",
                      code_rate_hp="5/6", guard="1/4", cell_id=0xC3)
        assert T.TpsWord.unpack(w.pack()) == w
    # sync words alternate by frame parity
    assert T.TpsWord(frame_number=0).sync_word() == T.TPS_SYNC_WORD_13
    assert T.TpsWord(frame_number=1).sync_word() == T.TPS_SYNC_WORD_24


def test_tps_dbpsk_frame_roundtrip():
    w = T.TpsWord(frame_number=2, constellation="qam16",
                  code_rate_hp="3/4", guard="1/8", cell_id=0xAB)
    bits = w.pack()
    cells = T.tps_encode_frame(bits)
    assert cells.shape == (68, 17)
    # common channel phase is transparent to DBPSK
    dec = T.tps_decode_frame(cells * np.exp(1j * 0.4))
    assert T.TpsWord.unpack(dec) == w


# ── GI sync ──────────────────────────────────────────────────────────────────

def _cp_signal(n_fft=2048, cp=64, n_sym=6, lead=300, seed=5):
    rng = np.random.default_rng(seed)
    syms = []
    for _ in range(n_sym):
        x = (rng.standard_normal(n_fft) + 1j * rng.standard_normal(n_fft)
             ).astype(np.complex64) / np.sqrt(2)
        syms.append(np.concatenate([x[-cp:], x]))
    sig = np.concatenate([np.zeros(lead, np.complex64)] + syms)
    return sig


def test_gi_sync_finds_boundary():
    sig = _cp_signal(lead=300)
    # search one symbol period (the documented usage; a wider span sees the
    # metric's period-2112 replicas)
    r = dvb_t_gi_sync(sig, 2048, 64, 1.2e6, 2048 + 64)
    assert r is not None and r.start_sample == 300
    assert r.score > 0.9


def test_gi_sync_cfo_estimate():
    fs = 1.2e6
    sig = _cp_signal(lead=100)
    z, _ = rotate(sig, 80.0, fs)
    r = dvb_t_gi_sync(np.asarray(z), 2048, 64, fs, 2048 + 64 + 150)
    assert r is not None and abs(r.cfo_hz - 80.0) < 5.0


def test_gi_refine_locks_locally():
    sig = _cp_signal(lead=500)
    r = dvb_t_gi_refine(sig, 2048, 64, 1.2e6, coarse=490, radius=20)
    assert r is not None and r.start_sample == 500


def test_integer_cfo_on_frame_spectrum():
    params = DvbTFrameParams(LINK, 0, 0)
    frame = DvbTFrameMod(params).modulate(_payload(184, 6))
    from orion_sdr_tpu.multicarrier import symbol_fft
    import jax.numpy as jnp
    freq = np.asarray(symbol_fft(jnp.asarray(frame.iq), 2048, 64, n_symbols=4))
    accum = np.sum(np.abs(freq) ** 2, axis=0).astype(np.complex64)
    est = dvb_t_integer_cfo(accum, 2048, 32)
    assert est.bins == 0 and est.confidence > 1.5
    # shifted spectrum reads back the shift
    for k in (-7, 3):
        est = dvb_t_integer_cfo(np.roll(accum, k), 2048, 32)
        assert est.bins == k


# ── frame capstones (ref roundtrip/dvb_t.rs) ─────────────────────────────────

def test_frame_tps_end_to_end_unknown_offset_awgn():
    """The reference capstone: TS payload → GI-acquire at unknown offset →
    payload + every TPS parameter recovered (4 dB for QPSK r1/2)."""
    params = DvbTFrameParams(LINK, 1, 0x5A)
    payload = _payload(500, 7)
    frame = DvbTFrameMod(params).modulate(payload)
    rng = np.random.default_rng(8)
    buf = np.concatenate([np.zeros(777, np.complex64), frame.iq,
                          np.zeros(2000, np.complex64)])
    sig_p = float(np.mean(np.abs(frame.iq) ** 2))
    buf += ((rng.standard_normal(len(buf)) + 1j * rng.standard_normal(len(buf)))
            .astype(np.complex64) * np.sqrt(sig_p / 10 ** 0.4 / 2))
    rx = DvbTFrameDemod(params).decode(buf, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)
    assert rx.tps == params.tps_word().__class__(
        frame_number=1, constellation="qpsk", code_rate_hp="1/2",
        guard="1/32", cell_id=0x5A)


def test_frame_qam16_r34_at_15db():
    params = DvbTFrameParams(DvbTLinkParams("1/8", "qam16", "3/4"), 0, 7)
    payload = _payload(400, 9)
    frame = DvbTFrameMod(params).modulate(payload)
    rng = np.random.default_rng(10)
    sig_p = float(np.mean(np.abs(frame.iq) ** 2))
    buf = frame.iq + ((rng.standard_normal(len(frame.iq)) +
                       1j * rng.standard_normal(len(frame.iq)))
                      .astype(np.complex64) * np.sqrt(sig_p / 10 ** 1.5 / 2))
    rx = DvbTFrameDemod(params).decode(buf, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)
    assert rx.tps.constellation == "qam16" and rx.tps.code_rate_hp == "3/4"


def test_frame_multipath_scattered_pilots_load_bearing():
    params = DvbTFrameParams(LINK, 0, 0)
    payload = _payload(300, 11)
    frame = DvbTFrameMod(params).modulate(payload)
    h = np.zeros(40, np.complex64)
    h[0], h[17] = 1.0, 0.4 * np.exp(1j * 1.1)
    mp = np.convolve(frame.iq, h).astype(np.complex64)
    rx = DvbTFrameDemod(params).decode(mp, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)


def test_frame_integer_cfo_builder_toggles():
    params = DvbTFrameParams(DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    payload = _payload(184, 12)
    frame = DvbTFrameMod(params).modulate(payload)
    fs = DvbTFrameDemod(params).fs
    z, _ = rotate(frame.iq, 3 * fs / 2048, fs)
    z = np.asarray(z)
    with pytest.raises(DvbTRxError):
        DvbTFrameDemod(params).decode(z, frame.n_symbols, len(payload))
    rx = DvbTFrameDemod(params).with_integer_cfo_correction(True) \
        .decode(z, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)


def test_frame_nb_modes_identical_structure():
    # NB scaling is fs metadata only: one frame decodes under any fs label
    params = DvbTFrameParams(LINK, 0, 0)
    payload = _payload(200, 13)
    frame = DvbTFrameMod(params).modulate(payload)
    rx = DvbTFrameDemod(params).decode(frame.iq, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)


# ── super-frame + streaming ──────────────────────────────────────────────────

def test_super_frame_roundtrip_cell_id():
    sp = DvbTSuperFrameParams(LINK, cell_id=0xBEEF)
    payload = _payload(2000, 14)
    sf = DvbTSuperFrameMod(sp).modulate(payload)
    rx = DvbTSuperFrameDemod(sp).decode(sf.iq, sf.symbols_per_frame,
                                        sf.frame_payload_lens)
    assert np.array_equal(rx.payload, payload)
    assert rx.cell_id == 0xBEEF


def test_stream_chunked_matches_oneshot():
    params = DvbTFrameParams(LINK, 0, 3)
    payload = _payload(300, 15)
    frame = DvbTFrameMod(params).modulate(payload)
    run = np.concatenate([frame.iq, frame.iq,
                          np.zeros(frame.samples_per_symbol, np.complex64)])
    one = DvbTFrameStreamDemod(params, frame.n_symbols, len(payload))
    a = one.feed(run) + one.flush()
    chunked = DvbTFrameStreamDemod(params, frame.n_symbols, len(payload))
    b = []
    for i in range(0, len(run), 37_000):
        b += chunked.feed(run[i:i + 37_000])
    b += chunked.flush()
    pa = [r.payload for r in a if hasattr(r, "payload")]
    pb = [r.payload for r in b if hasattr(r, "payload")]
    assert len(pa) == len(pb) == 2
    assert all(np.array_equal(x, payload) for x in pa + pb)


def test_stream_holds_partial_frame():
    params = DvbTFrameParams(LINK, 0, 0)
    payload = _payload(200, 16)
    frame = DvbTFrameMod(params).modulate(payload)
    st = DvbTFrameStreamDemod(params, frame.n_symbols, len(payload))
    assert st.feed(frame.iq[:len(frame.iq) // 2]) == []
    rest = st.feed(np.concatenate([frame.iq[len(frame.iq) // 2:],
                                   np.zeros(frame.samples_per_symbol,
                                            np.complex64)]))
    good = [r for r in rest if hasattr(r, "payload")]
    assert good and np.array_equal(good[0].payload, payload)


# ── spectral shaping on DVB-T ────────────────────────────────────────────────

def test_frame_shaped_window_and_mask_decodes():
    # taper + 89-tap mask with paired RX back-off (ref docs/performance.md:644)
    params = DvbTFrameParams(DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
    payload = _payload(300, 17)
    # guard budget: roll_off + group_delay ≤ min(cp−b, b); b = 64 is the
    # practical ceiling (the reference's own sweep shows b=85 never closes —
    # docs/performance.md:659-743)
    mask = tx_lowpass_for_2k(89, 60.0)   # group delay 44
    frame = DvbTFrameMod(params).with_symbol_window(40) \
        .with_tx_lowpass(mask).modulate(payload)
    rx = DvbTFrameDemod(params).with_rx_window_backoff(64) \
        .decode(frame.iq, frame.n_symbols, len(payload))
    assert np.array_equal(rx.payload, payload)


def test_decode_batch_matches_single():
    params = DvbTFrameParams(LINK, 1, 9)
    payload = _payload(500, 20)
    frame = DvbTFrameMod(params).modulate(payload)
    d = DvbTFrameDemod(params)
    outs = d.decode_batch(np.stack([frame.iq] * 3), frame.n_symbols,
                          len(payload))
    assert len(outs) == 3
    for o in outs:
        assert np.array_equal(o.payload, payload)
        assert o.tps.cell_id == 9


def test_super_frame_decode_batch_matches_decode():
    """Single-acquisition batched super-frame RX == the per-frame path,
    including under noise and a leading sample offset."""
    sp = DvbTSuperFrameParams(LINK, cell_id=0xBEEF)
    payload = _payload(2000, 16)
    sf = DvbTSuperFrameMod(sp).modulate(payload)
    rng = np.random.default_rng(17)
    sig = float(np.mean(np.abs(sf.iq) ** 2))
    cap = np.concatenate([np.zeros(0, np.complex64), np.asarray(sf.iq)])
    cap = cap + (rng.standard_normal(len(cap)) +
                 1j * rng.standard_normal(len(cap))
                 ).astype(np.complex64) * np.sqrt(sig / 10 ** 1.2 / 2)
    demod = DvbTSuperFrameDemod(sp)
    a = demod.decode(cap, sf.symbols_per_frame, sf.frame_payload_lens)
    b = demod.decode_batch(cap, sf.symbols_per_frame, sf.frame_payload_lens)
    assert np.array_equal(a.payload, b.payload)
    assert np.array_equal(b.payload, payload)
    assert a.cell_id == b.cell_id == 0xBEEF


def test_map_symbols_matches_point_table_exhaustively():
    # arithmetic Figure-9a mapper == the label->point table for EVERY label
    # (ulp-level tolerance: the table rounds once from f64, the arithmetic
    # path rounds the f32 product)
    from orion_sdr_tpu.waveform.dvb_t import dvb_t_map_symbols, _point_table
    for v in (2, 4, 6):
        labels = np.arange(1 << v)
        bits = ((labels[:, None] >> np.arange(v - 1, -1, -1)) & 1
                ).astype(np.uint8)
        got = np.asarray(dvb_t_map_symbols(bits.reshape(-1), v))
        np.testing.assert_allclose(got, _point_table(v), atol=5e-7)


def test_dvb_t_band_receive_two_muxes():
    """Two DVB-T multiplexes at different centers in one 4x-rate wideband
    capture: the batched channelizer + per-mux streams decode both."""
    import orion_sdr_tpu as sdr
    from orion_sdr_tpu.waveform.dvb_t import DvbTLinkParams, DvbTFrameParams
    from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod

    params = DvbTFrameParams(DvbTLinkParams("1/32", "qpsk", "1/2"), 0, 5)
    rng = np.random.default_rng(3)
    payloads = [rng.integers(0, 256, 300).astype(np.uint8) for _ in range(2)]
    frames = [DvbTFrameMod(params).modulate(p) for p in payloads]
    n_sym = frames[0].n_symbols

    fs = sdr.nb_bandwidth_fs(1_000_000.0)
    fs_wide = 4.0 * fs
    centers = [-1.4e6, 1.1e6]

    def up4(x):
        x = np.concatenate([np.zeros(256), np.asarray(x, np.complex128),
                            np.zeros(256)])
        X = np.fft.fft(x)
        n = len(x)
        Y = np.zeros(4 * n, np.complex128)
        Y[: n // 2] = X[: n // 2]
        Y[-(n - n // 2):] = X[n // 2:]
        return 4.0 * np.fft.ifft(Y)

    lens = [len(up4(f.iq)) for f in frames]
    n_wide = max(lens) + 40_000
    wide = np.zeros(n_wide, np.complex128)
    k = np.arange(n_wide)
    for i, f in enumerate(frames):
        x = up4(f.iq)
        up = np.zeros(n_wide, np.complex128)
        up[8_000 + 4_000 * i:8_000 + 4_000 * i + len(x)] = x
        wide += up * np.exp(2j * np.pi * centers[i] * k / fs_wide)
    wide = wide.astype(np.complex64)
    sig = float(np.mean(np.abs(wide) ** 2))
    wide += (rng.standard_normal(n_wide) + 1j * rng.standard_normal(n_wide)
             ).astype(np.complex64) * np.sqrt(sig * 0.002 / 2)

    rx = sdr.DvbTBandStreamDemod(params, n_sym, len(payloads[0]),
                                 centers, fs, fs_wide)
    got = {}
    for i in range(0, n_wide, 120_000):
        for c, res in rx.feed(wide[i:i + 120_000]).items():
            got.setdefault(c, []).extend(res)
    for c, res in rx.flush().items():
        got.setdefault(c, []).extend(res)
    for c, p in enumerate(payloads):
        frames_ok = [r for r in got.get(c, []) if hasattr(r, "payload")]
        assert frames_ok, (c, got.get(c))
        assert np.array_equal(frames_ok[0].payload, p), c
        assert frames_ok[0].tps.cell_id == 5


@pytest.mark.parametrize("entry", ["frame", "blind", "hierarchical"])
def test_kernel_fault_is_not_a_dropped_frame(entry, monkeypatch):
    """A Viterbi kernel that fails to build raises out of every DVB-T frame
    decoder; it is not reported as a corrupt frame."""
    import jax
    from orion_sdr_tpu.ops import viterbi as ov
    from orion_sdr_tpu.demodulate.dvb_t_frame import (DvbTHierFrameDemod,
                                                      dvb_t_blind_decode)
    from orion_sdr_tpu.waveform.dvb_t import (DvbTHierLinkParams,
                                              DvbTHierFrameParams)
    from orion_sdr_tpu.modulate.dvb_t_frame import DvbTHierFrameMod

    def no_nvcc():
        raise RuntimeError("nvcc failed: simulated")

    if entry == "hierarchical":
        params = DvbTHierFrameParams(link=DvbTHierLinkParams(
            guard="1/8", constellation="qam16", alpha=2, code_rate_hp="1/2",
            code_rate_lp="3/4"))
        frame = DvbTHierFrameMod(params).modulate(_payload(400, 1),
                                                  _payload(1200, 2))
        run = lambda: DvbTHierFrameDemod(params).decode(
            frame.iq, frame.n_symbols, 400, 1200)
    else:
        params = DvbTFrameParams(LINK, 0, 9)
        frame = DvbTFrameMod(params).modulate(_payload(500, 3))
        run = (lambda: DvbTFrameDemod(params).decode(
            frame.iq, frame.n_symbols, 500)) if entry == "frame" else \
            (lambda: dvb_t_blind_decode(frame.iq))
    jax.clear_caches()      # no decoder traced with the scan is reused
    monkeypatch.setattr(ov, "trellis_impl", lambda n_steps, K: "cuda")
    monkeypatch.setattr(ov, "_registered", False)
    monkeypatch.setattr(ov, "build_library", no_nvcc)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        run()
