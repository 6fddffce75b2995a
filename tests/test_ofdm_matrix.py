"""OFDM unit-depth permutation matrix + BER-threshold SNR regressions.

Mirrors the reference's two thinnest-covered
matrices — `tests/unit/ofdm.rs` (27 cases: mod geometry, equalizer
permutations, gain/scale conventions, spectral levers) and
`tests/roundtrip/ofdm_snr.rs:30-92` (`mean_ber_at_noise_scale` fixed
pass/fail CI gates, 50-trial Monte Carlo). Batched: the 50 AWGN trials
run as ONE batched demod instead of the reference's per-trial loop.
"""

import numpy as np
import pytest

import orion_sdr_tpu as sdr
from orion_sdr_tpu.multicarrier import (
    CarrierPlan, CarrierGrid, symbol_fft, ofdm_assemble, grid_extract,
)
from orion_sdr_tpu.ofdm import (
    OfdmConfig, ofdm_mod, ofdm_demod, ofdm_decide,
    channel_estimate_training, channel_estimate_pilots, zf_equalize,
    build_ofdm_rx_frame,
)

FS = 48_000.0
BPS = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6, "qam256": 8}


def make_cfg(order="qpsk", n_fft=64, cp=8, **kw):
    plan = CarrierPlan(n_fft, cp).with_contiguous_data()
    return OfdmConfig(plan, FS, constellation=order, **kw)


# ── BER-threshold SNR regressions (ref roundtrip/ofdm_snr.rs:30-92) ─────────


def mean_ber_at_noise_scale(cfg, noise_scale: float, seed: int,
                            trials: int = 50, n_symbols: int = 20) -> float:
    """Mean BER over `trials` AWGN draws at `noise_scale` relative to the
    time-domain signal power (the reference's CI-gate metric) — batched:
    one (trials, n) demod call."""
    bps = cfg.bits_per_ofdm_symbol()
    bits = (((np.arange(n_symbols * bps) // 7
              + np.arange(n_symbols * bps) % 5) & 1).astype(np.uint8))
    iq, _ = ofdm_mod(cfg, bits)
    iq = np.asarray(iq)
    sig_power = float(np.mean(np.abs(iq) ** 2))
    rng = np.random.default_rng(seed)
    sigma = np.sqrt(sig_power * noise_scale / 2.0)
    noise = (rng.standard_normal((trials, len(iq)))
             + 1j * rng.standard_normal((trials, len(iq)))) * sigma
    batch = (iq[None, :] + noise).astype(np.complex64)
    soft, _ = ofdm_demod(cfg, batch)
    out = np.asarray(ofdm_decide(cfg, soft))
    return float(np.mean(out != bits[None, :]))


class TestBerRegressionGates:
    """Fixed pass/fail thresholds, CI-gated like the reference's
    `ofdm_qpsk_ber_below_threshold_at_moderate_snr` family."""

    def test_qpsk_ber_below_threshold_at_moderate_snr(self):
        ber = mean_ber_at_noise_scale(make_cfg("qpsk"), 0.02, 0x1234)
        assert ber < 0.01, ber

    def test_qpsk_ber_degrades_at_low_snr(self):
        ber = mean_ber_at_noise_scale(make_cfg("qpsk"), 2.0, 0x9ABC)
        assert ber > 0.1, ber

    def test_bpsk_ber_below_threshold_at_moderate_snr(self):
        ber = mean_ber_at_noise_scale(make_cfg("bpsk"), 0.05, 0x2222)
        assert ber < 0.01, ber

    def test_qam16_ber_below_threshold_at_high_snr(self):
        ber = mean_ber_at_noise_scale(make_cfg("qam16"), 0.005, 0x3333)
        assert ber < 0.01, ber

    def test_qam64_ber_below_threshold_at_high_snr(self):
        ber = mean_ber_at_noise_scale(make_cfg("qam64"), 0.001, 0x4444)
        assert ber < 0.01, ber

    @pytest.mark.parametrize("order,lo,hi", [
        ("qpsk", 2e-4, 5e-3),       # ref 0.00102 (performance.md:175-186)
        ("qam16", 0.03, 0.08),      # ref 0.0525
        ("qam64", 0.10, 0.20),      # ref 0.1501
    ])
    def test_uncoded_ber_at_noise_0p1_matches_reference_waterfall(
            self, order, lo, hi):
        """BASELINE.md's flat-channel BER@noise-0.1 table, gated as a band:
        a demap or scale regression moves these far outside."""
        ber = mean_ber_at_noise_scale(make_cfg(order), 0.1, 0x5555)
        assert lo < ber < hi, (order, ber)


# ── mod geometry (ref unit/ofdm.rs mod tier) ────────────────────────────────


class TestModGeometry:
    @pytest.mark.parametrize("order", list(BPS))
    def test_symbol_length_per_constellation(self, order):
        cfg = make_cfg(order)
        bps = cfg.bits_per_ofdm_symbol()
        bits = np.zeros(3 * bps, np.uint8)
        iq, _ = ofdm_mod(cfg, bits)
        assert len(np.asarray(iq)) == 3 * cfg.samples_per_ofdm_symbol()
        assert bps == cfg.carrier_plan.num_data_carriers() * BPS[order]

    def test_partial_bits_pad_to_whole_symbol(self):
        # bits short of a symbol boundary zero-pad up (OfdmMod::modulate)
        cfg = make_cfg("qpsk")
        bps = cfg.bits_per_ofdm_symbol()
        iq, _ = ofdm_mod(cfg, np.ones(bps + 3, np.uint8))
        assert len(np.asarray(iq)) == 2 * cfg.samples_per_ofdm_symbol()

    def test_zero_pads_final_partial_symbol(self):
        # the padded tail decodes as 0-bits (ref ofdm_mod_zero_pads_...)
        cfg = make_cfg("qpsk")
        bps = cfg.bits_per_ofdm_symbol()
        rng = np.random.default_rng(0)
        bits = rng.integers(0, 2, bps + bps // 2).astype(np.uint8)
        iq, _ = ofdm_mod(cfg, bits)
        soft, _ = ofdm_demod(cfg, iq)
        out = np.asarray(ofdm_decide(cfg, soft))
        assert np.array_equal(out[:len(bits)], bits)
        assert not out[len(bits):].any()

    def test_multi_symbol_batch_matches_streamed(self):
        # 4 symbols in one call == two 2-symbol calls (no cross-symbol state
        # at rf_hz=0)
        cfg = make_cfg("qam16")
        bps = cfg.bits_per_ofdm_symbol()
        rng = np.random.default_rng(1)
        bits = rng.integers(0, 2, 4 * bps).astype(np.uint8)
        whole, _ = ofdm_mod(cfg, bits)
        a, _ = ofdm_mod(cfg, bits[:2 * bps])
        b, _ = ofdm_mod(cfg, bits[2 * bps:])
        np.testing.assert_allclose(np.asarray(whole),
                                   np.concatenate([np.asarray(a),
                                                   np.asarray(b)]),
                                   atol=1e-6)

    def test_null_carriers_are_silent(self):
        # non-data, non-pilot bins carry no energy (ref
        # ofdm_mod_null_carriers_are_silent)
        plan = CarrierPlan(64, 8).with_contiguous_data(edge_guard=8)
        cfg = OfdmConfig(plan, FS, constellation="qpsk")
        rng = np.random.default_rng(2)
        bits = rng.integers(0, 2, 6 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq, _ = ofdm_mod(cfg, bits)
        g = CarrierGrid(plan)
        freq = np.asarray(symbol_fft(np.asarray(iq), g.n_fft, g.cp_len,
                                     n_symbols=6))
        used = set(int(b) for b in g.data_bins) \
            | set(int(b) for b in np.atleast_1d(g.pilot_bins).reshape(-1))
        silent = [b for b in range(64) if b not in used]
        assert np.max(np.abs(freq[:, silent])) < 1e-5
        assert np.max(np.abs(freq[:, sorted(used)])) > 0.1

    def test_cp_matches_symbol_tail(self):
        cfg = make_cfg("qpsk", n_fft=64, cp=16)
        rng = np.random.default_rng(3)
        bits = rng.integers(0, 2, 2 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0]).reshape(2, 80)
        np.testing.assert_allclose(iq[:, :16], iq[:, 64:], atol=1e-7)

    def test_rf_upconversion_shifts_spectrum(self):
        rf = 9000.0
        # narrow occupied band (edge_guard) so the 9 kHz shift cannot wrap
        plan = CarrierPlan(64, 8).with_contiguous_data(edge_guard=24)
        cfg = OfdmConfig(plan, FS, constellation="qpsk", rf_hz=rf)
        rng = np.random.default_rng(4)
        bits = rng.integers(0, 2, 16 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        spec = np.abs(np.fft.fft(iq))
        freqs = np.fft.fftfreq(len(iq), 1.0 / FS)
        # energy-weighted center lands near the carrier
        center = float(np.sum(freqs * spec ** 2) / np.sum(spec ** 2))
        assert abs(center - rf) < 1500.0, center

    def test_tx_gain_scales_and_demod_inverts(self):
        # ref ofdm_mod_applies_tx_gain_and_demod_inverts_it
        cfg1 = make_cfg("qpsk")
        cfg3 = make_cfg("qpsk", gain=3.0)
        rng = np.random.default_rng(5)
        bits = rng.integers(0, 2, 2 * cfg1.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq1 = np.asarray(ofdm_mod(cfg1, bits)[0])
        iq3 = np.asarray(ofdm_mod(cfg3, bits)[0])
        np.testing.assert_allclose(iq3, 3.0 * iq1, atol=1e-6)
        # RX gain 1/g inverts TX gain g (the reference's set_gain contract)
        s1 = np.asarray(ofdm_demod(cfg1, iq1)[0])
        s3 = np.asarray(ofdm_demod(cfg3, iq3, gain=1.0 / 3.0)[0])
        np.testing.assert_allclose(s3, s1, atol=1e-5)

    def test_ifft_bin_scale_is_unitary_roundtrip(self):
        # the package's FFT convention: ofdm_assemble ∘ symbol_fft == id on
        # the occupied grid (ref pins 1/n on the raw IFFT; here the pair's
        # consistency is the invariant every chain depends on)
        g = CarrierGrid(CarrierPlan(64, 8).with_contiguous_data())
        rng = np.random.default_rng(6)
        freq = (rng.standard_normal((2, 64))
                + 1j * rng.standard_normal((2, 64))).astype(np.complex64)
        t = ofdm_assemble(freq, 8)
        back = np.asarray(symbol_fft(t, 64, 8, n_symbols=2))
        np.testing.assert_allclose(back, freq, atol=1e-4)


# ── demod / equalizer permutations (ref unit/ofdm.rs equalizer tier) ────────


def _apply_static_bin_channel(cfg, iq, h):
    """Re-synthesize each symbol through a per-bin channel H (the reference's
    apply_bin_channel helper, unit/ofdm.rs:453-466)."""
    g = CarrierGrid(cfg.carrier_plan)
    n_sym = len(iq) // cfg.samples_per_ofdm_symbol()
    freq = np.asarray(symbol_fft(np.asarray(iq), g.n_fft, g.cp_len,
                                 n_symbols=n_sym))
    return np.asarray(ofdm_assemble(freq * h, g.cp_len))


class TestEqualizerMatrix:
    def test_training_hold_corrects_static_multipath(self):
        # per-bin complex channel + training estimate → bit-exact decode
        cfg = make_cfg("qam16")
        rng = np.random.default_rng(7)
        bits = rng.integers(0, 2, 8 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        h = (0.5 + 0.4 * np.cos(2 * np.pi * np.arange(64) / 64)
             + 0.3j * np.sin(2 * np.pi * 3 * np.arange(64) / 64)
             ).astype(np.complex64) + 0.4
        rx = _apply_static_bin_channel(cfg, iq, h)
        known = np.ones(64, np.complex64)
        est = np.asarray(channel_estimate_training(h * known, known))
        soft, _ = ofdm_demod(cfg, rx, estimate=est)
        out = np.asarray(ofdm_decide(cfg, soft))
        assert np.array_equal(out, bits)

    def test_pilot_interp_exact_between_pilots_for_linear_channel(self):
        # linear-in-bin channel: linear interpolation is EXACT between
        # pilots (ref ofdm_equalizer_interp_between_pilots)
        n_fft = 16
        pilots = [(3, 1.0 + 0j), (6, 1.0 + 0j)]
        pb = np.array([3, 6])
        pv = np.array([1.0 + 0j, 1.0 + 0j], np.complex64)
        h = (0.4 + np.arange(n_fft) * 0.05
             + 1j * (0.2 - np.arange(n_fft) * 0.01)).astype(np.complex64)
        freq = (h * 1.0)[None, :]          # one symbol, known flat data 1.0
        est = np.asarray(channel_estimate_pilots(freq, pb, pv, n_fft))[0]
        for b in (4, 5):
            assert abs(est[b] - h[b]) < 1e-5, b

    def test_pilot_interp_nearest_hold_outside_span(self):
        # out-of-span bins take the nearest pilot's ratio (ref
        # ofdm_equalizer_pilot_interp_extrapolates_outside_pilot_span)
        n_fft = 16
        pb = np.array([3, 6])
        pv = np.array([1.0 + 0j, 1.0 + 0j], np.complex64)
        h = np.full(n_fft, 0.7 * np.exp(0.4j), np.complex64)
        est = np.asarray(channel_estimate_pilots(h[None, :], pb, pv,
                                                 n_fft))[0]
        for b in (0, 1, 2, 7, 12, 15):
            assert abs(est[b] - h[3 if b < 3 else 6]) < 1e-5

    def test_pilot_interp_equalizes_constant_channel_out_of_span_bins(self):
        # end-to-end: plan with data outside the pilot span still equalizes
        plan = CarrierPlan(16, 4).with_data_carriers([1, 4, 5, 7]) \
            .with_pilot_carriers([(3, 1.0 + 0j), (6, 1.0 + 0j)])
        cfg = OfdmConfig(plan, FS, constellation="qpsk",
                         equalizer_method="pilot_interp")
        rng = np.random.default_rng(8)
        bits = rng.integers(0, 2, 4 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        h = np.full(16, 0.7 * np.exp(0.4j), np.complex64)
        rx = _apply_static_bin_channel(cfg, iq, h)
        soft, _ = ofdm_demod(cfg, rx)
        out = np.asarray(ofdm_decide(cfg, soft))
        assert np.array_equal(out, bits)

    def test_pilot_interp_without_pilots_is_flat_noop(self):
        # plan without pilots + pilot_interp config == flat-channel demod
        cfg = make_cfg("qpsk", equalizer_method="pilot_interp")
        assert CarrierGrid(cfg.carrier_plan).pilot_bins.size == 0
        rng = np.random.default_rng(9)
        bits = rng.integers(0, 2, 4 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        flat = np.asarray(ofdm_demod(make_cfg("qpsk"), iq)[0])
        pi = np.asarray(ofdm_demod(cfg, iq)[0])
        np.testing.assert_allclose(pi, flat, atol=1e-6)

    @pytest.mark.parametrize("backoff", [0, 2])
    @pytest.mark.parametrize("equalizer", ["training_symbol", "pilot_interp"])
    def test_backoff_by_equalizer_permutation_decodes(self, backoff,
                                                      equalizer):
        """window backoff × equalizer grid (the reference's permutation
        dimensions) under mild noise — every combination must decode.
        Backoff rotates each bin by a phase ramp, so a non-zero backoff
        NEEDS its equalizer: training-hold learns the ramp from a known
        symbol demodulated through the same window; pilot_interp needs
        pilot spacing within max_pilot_safe_backoff."""
        from orion_sdr_tpu.multicarrier import max_pilot_safe_backoff
        est = None
        if equalizer == "pilot_interp":
            # pilots must SPAN the data range: backoff's per-bin phase ramp
            # makes nearest-pilot hold wrong outside the span
            spacing = 4
            pilots = [(b, 1.0 + 0j)
                      for b in range(-28, 29, spacing) if b != 0]
            plan = CarrierPlan(64, 16).with_pilot_carriers(pilots) \
                .with_contiguous_data(edge_guard=4)
            assert backoff <= max_pilot_safe_backoff(64, spacing)
        else:
            plan = CarrierPlan(64, 16).with_contiguous_data(edge_guard=4)
        cfg = OfdmConfig(plan, FS, constellation="qpsk",
                         equalizer_method=equalizer,
                         rx_window_backoff=backoff)
        rng = np.random.default_rng(10 + backoff)
        bps = cfg.bits_per_ofdm_symbol()
        if equalizer == "training_symbol":
            # known training symbol through the same backoff window → est
            known_bits = (np.arange(bps) & 1).astype(np.uint8)
            tiq = np.asarray(ofdm_mod(cfg, known_bits)[0])
            g = CarrierGrid(cfg.carrier_plan)
            rx_freq = np.asarray(symbol_fft(tiq, g.n_fft, g.cp_len,
                                            backoff=backoff, n_symbols=1))[0]
            clean_freq = np.asarray(symbol_fft(tiq, g.n_fft, g.cp_len,
                                               backoff=0, n_symbols=1))[0]
            est = np.asarray(channel_estimate_training(rx_freq, clean_freq))
        bits = rng.integers(0, 2, 6 * bps).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        iq = iq + np.asarray(sdr.awgn(rng, len(iq), 1e-3))
        # soft_demap applies the config's equalizer (pilot_interp per
        # symbol, else the held estimate) — the frame RX operating path
        from orion_sdr_tpu.frame.demodulator import soft_demap
        llr = np.asarray(soft_demap(cfg, "qpsk", iq, 6, est)).reshape(-1)
        out = (llr < 0).astype(np.uint8)      # positive LLR ⇒ bit 0
        assert np.array_equal(out, bits), (backoff, equalizer)

    def test_evm_matches_known_error_magnitude(self):
        # inject ε on every data symbol → evm_db == 20·log10(ε/rms) (ref
        # ofdm_rx_frame_evm_matches_known_error_magnitude)
        cfg = make_cfg("qpsk")
        rng = np.random.default_rng(11)
        bits = rng.integers(0, 2, 4 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        soft, _ = ofdm_demod(cfg, iq)
        eps = 0.05
        soft_err = np.asarray(soft) + eps
        frame = build_ofdm_rx_frame(cfg, soft_err,
                                    np.asarray(ofdm_decide(cfg, soft_err)))
        # QPSK constellation rms is 1 by convention
        expect = 20.0 * np.log10(eps)
        assert abs(frame.evm_db - expect) < 1.0, (frame.evm_db, expect)


# ── symbol-window builder arithmetic (ref unit/ofdm.rs window tier) ─────────


class TestSymbolWindowBuilders:
    def test_with_symbol_window_sets_roll_off(self):
        cfg = make_cfg("qpsk", n_fft=256, cp=64).with_symbol_window(32)
        assert cfg.carrier_plan.window_roll_off == 32

    def test_beta_guard_is_fraction_of_cp(self):
        cfg = make_cfg("qpsk", n_fft=256, cp=64) \
            .with_symbol_window_beta_guard(0.5)
        assert cfg.carrier_plan.window_roll_off == 32

    def test_beta_tu_is_fraction_of_n_fft(self):
        cfg = make_cfg("qpsk", n_fft=256, cp=64) \
            .with_symbol_window_beta_tu(0.125)
        assert cfg.carrier_plan.window_roll_off == 32


class TestSoftLlrConsistency:
    @pytest.mark.parametrize("order", list(BPS))
    def test_llr_sign_matches_hard_decision(self, order):
        """ref ofdm_soft_llr_sign_matches_hard_decision: under noise, the
        max-log LLR signs reproduce ofdm_decide's hard bits exactly."""
        from orion_sdr_tpu.ofdm import ofdm_soft_demod
        cfg = make_cfg(order)
        rng = np.random.default_rng(21)
        bits = rng.integers(0, 2, 4 * cfg.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        iq = np.asarray(ofdm_mod(cfg, bits)[0])
        iq = iq + np.asarray(sdr.awgn(rng, len(iq), 0.05))
        soft, _ = ofdm_demod(cfg, iq)
        hard = np.asarray(ofdm_decide(cfg, soft))
        llr = np.asarray(ofdm_soft_demod(cfg, soft)).reshape(-1)
        # positive LLR ⇒ bit 0 (project-wide convention)
        assert np.array_equal((llr < 0).astype(np.uint8), hard)


class TestShapingLevers:
    @pytest.mark.parametrize("roll_off", [8, 16, 32])
    def test_mod_taper_touches_only_symbol_edges(self, roll_off):
        # taper scales the first/last roll_off samples of each symbol and
        # leaves the interior bit-identical to the untapered frame
        plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
        cfg0 = OfdmConfig(plan, FS, constellation="qpsk")
        cfgt = cfg0.with_symbol_window(roll_off)
        rng = np.random.default_rng(31)
        bits = rng.integers(0, 2, 2 * cfg0.bits_per_ofdm_symbol()
                            ).astype(np.uint8)
        a = np.asarray(ofdm_mod(cfg0, bits)[0]).reshape(2, -1)
        b = np.asarray(ofdm_mod(cfgt, bits)[0]).reshape(2, -1)
        sps = cfg0.samples_per_ofdm_symbol()
        mid = slice(roll_off, sps - roll_off)
        np.testing.assert_array_equal(a[:, mid], b[:, mid])
        assert not np.allclose(a[:, :roll_off], b[:, :roll_off])

    def test_tx_lowpass_null_band_builder_sizes_mask(self):
        plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=31)
        cfg = OfdmConfig(plan, FS, constellation="qpsk") \
            .with_tx_lowpass_null_band(65, 60.0)
        lp = cfg.tx_lowpass
        assert lp is not None and lp.num_taps == 65
        assert lp.group_delay() == 32
        # cutoff sits above the occupied edge, below Nyquist
        occ = 96 / 256.0
        assert occ < lp.cutoff_norm < 0.5

    def test_tx_lowpass_guard_budget_rule(self):
        from orion_sdr_tpu.multicarrier import TxLowpass
        lp = TxLowpass.for_null_band(256, 97, 45, 60.0)
        # roll_off + group_delay <= min(cp_len - backoff, backoff)
        assert lp.fits_guard(cp_len=64, roll_off=8, backoff=32)
        assert not lp.fits_guard(cp_len=64, roll_off=16, backoff=32)
