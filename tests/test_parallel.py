"""Multi-device sharding tests on the virtual 8-device CPU mesh.

The story the reference never had (SURVEY.md §4 'multi-node story: N/A'):
sharded outputs must match single-device outputs.
"""

import os

import numpy as np
import pytest
import jax

from orion_sdr_tpu import dsp
from orion_sdr_tpu.parallel import (
    make_mesh, shard_channels, fir_overlap_save_sharded, fm_demod_sharded,
)
import orion_sdr_tpu as sdr


@pytest.fixture(scope="module")
def mesh8():
    assert len(jax.devices()) >= 8
    return make_mesh(8, shape=(2, 4))  # 2 channel groups × 4 time blocks


class TestSharding:
    def test_fir_overlap_save_matches_single_device(self, mesh8):
        rng = np.random.default_rng(0)
        x = (rng.standard_normal((2, 4096)) + 1j * rng.standard_normal((2, 4096))
             ).astype(np.complex64)
        taps = dsp.kaiser_lowpass_taps(63, 0.2, 60.0)
        ref, _ = dsp.fir_apply(x, taps)
        out = fir_overlap_save_sharded(x, taps, mesh8)
        np.testing.assert_allclose(np.asarray(out), np.asarray(ref), atol=1e-5)

    def test_channel_sharded_pipeline(self, mesh8):
        rng = np.random.default_rng(1)
        x = (rng.standard_normal((8, 1024)) + 1j * rng.standard_normal((8, 1024))
             ).astype(np.complex64)
        mesh = make_mesh(8, shape=(8, 1))

        def pipeline(z):
            y, _ = dsp.rotate(z, -1000.0, 48e3)
            return (y.real ** 2 + y.imag ** 2)

        f = shard_channels(pipeline, mesh)
        out = np.asarray(f(x))
        ref = np.asarray(pipeline(x))
        np.testing.assert_allclose(out, ref, atol=1e-5)

    def test_fm_demod_sharded_matches_reference_chain(self, mesh8):
        # time+channel sharded FM discriminator ≈ single-device result
        fs = 48e3
        n = 8192
        t = np.arange(n) / fs
        audio = 0.5 * np.sin(2 * np.pi * 1000.0 * t).astype(np.float32)
        from orion_sdr_tpu.modulate import fm_mod
        iq, _ = fm_mod(np.stack([audio, audio]), fs, 2500.0)
        iq = np.asarray(iq)
        taps = dsp.kaiser_lowpass_taps(31, 0.25, 50.0)

        out = np.asarray(fm_demod_sharded(iq, taps, mesh8, fs, 2500.0))
        # single-device reference of the same chain
        y, _ = dsp.fir_apply(iq, taps)
        y = np.asarray(y)
        prev = np.concatenate([np.zeros((2, 1), np.complex64), y[:, :-1]], axis=1)
        prod = y * np.conj(prev)
        ref = np.arctan2(prod.imag, prod.real) / 2500.0
        np.testing.assert_allclose(out[:, 1:], ref[:, 1:], atol=1e-4)

    def test_ofdm_soft_demap_sharded_matches(self, mesh8):
        # symbol-aligned time+channel sharding: no halo, exact equivalence
        from orion_sdr_tpu.frame.demodulator import soft_demap
        from orion_sdr_tpu.parallel import ofdm_soft_demap_sharded
        plan = sdr.CarrierPlan(128, 32).with_contiguous_data(edge_guard=8)
        cfg = sdr.OfdmConfig(plan, fs=1e6)
        rng = np.random.default_rng(3)
        n_sym = 16
        iq = (rng.standard_normal((2, n_sym * 160)) +
              1j * rng.standard_normal((2, n_sym * 160))).astype(np.complex64)
        ref = soft_demap(cfg, "qpsk", iq, n_sym)
        out = ofdm_soft_demap_sharded(cfg, "qpsk", iq, n_sym, mesh8)
        np.testing.assert_allclose(out, ref, atol=1e-4)

    def test_ofdm_soft_demap_sharded_matches_with_estimate(self, mesh8):
        # held-estimate path: ZF + CSI LLR weighting must be shard-invariant
        # (per-symbol normalization keeps the weights local to each shard)
        from orion_sdr_tpu.frame.demodulator import soft_demap
        from orion_sdr_tpu.parallel import ofdm_soft_demap_sharded
        plan = sdr.CarrierPlan(128, 32).with_contiguous_data(edge_guard=8)
        cfg = sdr.OfdmConfig(plan, fs=1e6)
        rng = np.random.default_rng(4)
        n_sym = 16
        iq = (rng.standard_normal((2, n_sym * 160)) +
              1j * rng.standard_normal((2, n_sym * 160))).astype(np.complex64)
        # non-flat channel: magnitude AND phase vary across bins
        est = (0.5 + rng.random(128) +
               1j * 0.3 * rng.standard_normal(128)).astype(np.complex64)
        ref = soft_demap(cfg, "qpsk", iq, n_sym, est)
        out = ofdm_soft_demap_sharded(cfg, "qpsk", iq, n_sym, mesh8,
                                      estimate=est)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    def test_ofdm_soft_demap_sharded_matches_precoded(self, mesh8):
        # DFT-s-OFDM despread is symbol-local: sharded == single-device,
        # training-hold estimate broadcast, no halo
        from orion_sdr_tpu.frame.demodulator import soft_demap
        from orion_sdr_tpu.parallel import ofdm_soft_demap_sharded
        plan = sdr.CarrierPlan(128, 32).with_contiguous_data(edge_guard=8)
        cfg = sdr.OfdmConfig(plan, fs=1e6).with_transform_precoding()
        rng = np.random.default_rng(6)
        n_sym = 16
        iq = (rng.standard_normal((2, n_sym * 160)) +
              1j * rng.standard_normal((2, n_sym * 160))).astype(np.complex64)
        est = (0.6 + rng.random(128) +
               1j * 0.2 * rng.standard_normal(128)).astype(np.complex64)
        ref = soft_demap(cfg, "qam16", iq, n_sym, est)
        out = ofdm_soft_demap_sharded(cfg, "qam16", iq, n_sym, mesh8,
                                      estimate=est)
        np.testing.assert_allclose(out, ref, atol=1e-4, rtol=1e-4)

    def test_ofdm_soft_demap_sharded_matches_cpe(self, mesh8):
        # phase_tracking='cpe': the V&V unwrap runs along the WHOLE symbol
        # axis (all-gathered over 't'); must equal the single-device demap
        from orion_sdr_tpu.frame.demodulator import soft_demap
        from orion_sdr_tpu.parallel import ofdm_soft_demap_sharded
        plan = sdr.CarrierPlan(128, 32).with_contiguous_data(edge_guard=8)
        cfg = sdr.OfdmConfig(plan, fs=1e6).with_phase_tracking("cpe")
        rng = np.random.default_rng(5)
        n_sym = 16
        from orion_sdr_tpu.constellation import map_bits
        nd = plan.num_data_carriers()
        bits = rng.integers(0, 2, 2 * n_sym * nd * 2).astype(np.uint8)
        pts = np.asarray(map_bits(bits, "qpsk")).reshape(2, n_sym, nd)
        # a slow phase walk across symbols so CPE actually acts
        walk = np.cumsum(rng.normal(0, 0.05, (2, n_sym)), axis=-1)
        from orion_sdr_tpu.multicarrier import CarrierGrid, grid_map
        from orion_sdr_tpu.ofdm import OfdmConfig as _O
        g = CarrierGrid(plan)
        freq = np.asarray(grid_map(g, (pts * np.exp(1j * walk)[..., None]
                                       ).astype(np.complex64)))
        t = np.fft.ifft(freq, axis=-1).astype(np.complex64)
        cp = t[..., -32:]
        iq = np.concatenate([cp, t], axis=-1).reshape(2, -1)
        ref = soft_demap(cfg, "qpsk", iq, n_sym)
        out = ofdm_soft_demap_sharded(cfg, "qpsk", iq, n_sym, mesh8)
        np.testing.assert_allclose(out, ref, atol=1e-3, rtol=1e-3)

    def test_dvb_t_receive_sharded_matches(self, mesh8):
        # service-parallel DVB-T: 8 aligned frames, one per device,
        # sharded fused receive == single-device receive
        from orion_sdr_tpu.parallel import dvb_t_receive_sharded
        from orion_sdr_tpu.demodulate.dvb_t_frame import _receive_frame
        from orion_sdr_tpu.waveform.dvb_t import guard_cp_len_2k
        from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod
        import orion_sdr_tpu as sdr

        link = sdr.DvbTLinkParams(guard="1/32", constellation="qpsk",
                                  code_rate="1/2")
        cp = guard_cp_len_2k(link.guard)
        rng = np.random.default_rng(5)
        frames = []
        n_sym = None
        for i in range(8):
            params = sdr.DvbTFrameParams(link, frame_number=i % 4, cell_id=i)
            f = DvbTFrameMod(params).modulate(bytes(rng.integers(
                0, 256, 100).astype(np.uint8)))
            n_sym = f.n_symbols
            frames.append(np.asarray(f.iq)[: n_sym * (2048 + cp)])
        segs = np.stack(frames)
        llrs, cells = dvb_t_receive_sharded(segs, n_sym, cp, 0, 2, mesh8)
        ref_l, ref_c = _receive_frame(segs, n_sym, cp, 0, 2)
        np.testing.assert_allclose(llrs, np.asarray(ref_l), atol=1e-3)
        np.testing.assert_allclose(cells, np.asarray(ref_c), atol=1e-4)


# ── time-sharded streaming state (SURVEY §5) ──────────────────────────────────

from orion_sdr_tpu.parallel import (
    psk31_demod_sharded, psk31_stream_decode_sharded, viterbi_decode_sharded,
    forney_deinterleave_sharded, dvb_t_receive_time_sharded,
    dvb_t_decode_time_sharded, make_process_mesh, ber_sharded,
    power_spectrum_sharded, measure_scaling, format_scaling_table,
)


class TestStreamingState:
    def test_psk31_demod_sharded_matches_single(self, mesh8):
        """AFC/PLL phase: sharded matched-filter matmul + replicated PLL
        equals the single-device decision-feedback demod."""
        from orion_sdr_tpu.modulate.psk31 import bpsk31_mod_text
        fs = 8000.0
        iq = bpsk31_mod_text("the quick brown fox", fs)
        iq = np.asarray(iq)
        ref = np.asarray(sdr.bpsk31_demod(iq, fs))
        out = psk31_demod_sharded(iq, mesh8, fs)
        n = min(len(ref), len(out))
        assert n > 100
        np.testing.assert_allclose(out[:n], ref[:n], atol=1e-5)

    def test_psk31_stream_decode_sharded_text(self, mesh8):
        from orion_sdr_tpu.modulate.psk31 import bpsk31_mod_text
        fs = 8000.0
        text = "gpu native psk31 stream"
        iq = bpsk31_mod_text(text, fs)
        decoded = psk31_stream_decode_sharded(np.asarray(iq), mesh8, fs)
        assert text in decoded

    def test_viterbi_sharded_matches_chunked(self, mesh8):
        """Trellis state: LLR-halo sharded decode equals the single-device
        overlap-chunked decode bit for bit."""
        from orion_sdr_tpu.fec import conv as fc
        rng = np.random.default_rng(3)
        info = rng.integers(0, 2, 30_000).astype(np.uint8)
        coded = np.asarray(fc.conv_encode_punctured(info, "3/4", "dvb_k7"))
        llr = ((1.0 - 2.0 * coded.astype(np.float32)) * 3.0
               + rng.standard_normal(len(coded)).astype(np.float32))
        ref = np.asarray(fc.viterbi_decode_soft_chunked(
            llr, len(info), "3/4", "dvb_k7"))
        out = viterbi_decode_sharded(llr, len(info), mesh8, "3/4", "dvb_k7")
        assert np.array_equal(out, ref)
        assert np.mean(out != info) < 1e-3

    def test_forney_sharded_bit_exact(self, mesh8):
        """Interleaver lines: delay-line halo equals the streaming Forney."""
        from orion_sdr_tpu.fec.interleave import forney_deinterleave
        rng = np.random.default_rng(4)
        x = rng.integers(0, 256, 48_000).astype(np.uint8)
        ref, _ = forney_deinterleave(x)
        out = forney_deinterleave_sharded(x, mesh8)
        assert np.array_equal(out, np.asarray(ref))

    def test_dvb_t_decode_time_sharded_capstone(self, mesh8):
        """One long conformant DVB-T capture decoded across the mesh equals
        the single-device frame decode (payload + TPS)."""
        from orion_sdr_tpu.waveform import DvbTFrameParams, DvbTLinkParams
        from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod
        from orion_sdr_tpu.demodulate.dvb_t_frame import DvbTFrameDemod
        params = DvbTFrameParams(DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0)
        rng = np.random.default_rng(5)
        payload = rng.integers(0, 256, 4000).astype(np.uint8)
        frame = DvbTFrameMod(params).modulate(payload)
        iq = np.concatenate([np.zeros(1500, np.complex64), frame.iq])
        single = DvbTFrameDemod(params).decode(iq, frame.n_symbols,
                                               len(payload))
        sharded = dvb_t_decode_time_sharded(iq, frame.n_symbols,
                                            len(payload), params, mesh8)
        assert np.array_equal(sharded.payload, single.payload)
        assert sharded.tps == single.tps


class TestDistributed:
    def test_process_mesh_single_host_shape(self):
        mesh = make_process_mesh()
        assert mesh.devices.shape == (1, 8)
        assert mesh.axis_names == ("host", "chip")

    def test_ber_sharded_counts(self):
        mesh = make_mesh(8, shape=(8, 1))
        from jax.sharding import Mesh
        import jax as _jax
        flat = Mesh(np.array(_jax.devices()[:8]), ("ch",))
        rng = np.random.default_rng(6)
        ref = rng.integers(0, 2, (8, 1000)).astype(np.uint8)
        hat = ref.copy()
        hat[3, :17] ^= 1          # 17 injected errors
        ber, errs, n = ber_sharded(ref, hat, flat)
        assert errs == 17 and n == 8000
        assert abs(ber - 17 / 8000) < 1e-12

    def test_power_spectrum_sharded_matches_host(self):
        import jax as _jax
        from jax.sharding import Mesh
        flat = Mesh(np.array(_jax.devices()[:8]), ("ch",))
        rng = np.random.default_rng(7)
        x = (rng.standard_normal((8, 4096))
             + 1j * rng.standard_normal((8, 4096))).astype(np.complex64)
        got = power_spectrum_sharded(x, flat, nfft=512)
        segs = x.reshape(8, 8, 512)
        want = np.mean(np.abs(np.fft.fft(segs, axis=-1)) ** 2, axis=(0, 1))
        np.testing.assert_allclose(got, want, rtol=2e-4)

    def test_measure_scaling_runs_and_formats(self):
        """The efficiency harness runs on the virtual mesh and reports
        sane numbers (weak-scaling FIR chain)."""
        from jax.sharding import PartitionSpec as P, NamedSharding
        import jax as _jax
        taps = np.asarray(dsp.kaiser_lowpass_taps(31, 0.2, 50.0), np.float32)

        def make_fn(mesh):
            def fn(x):
                sh = NamedSharding(mesh, P("ch", None))
                y, _ = _jax.jit(lambda z: dsp.fir_apply(z, taps))(
                    _jax.device_put(x, sh))
                return y
            return fn

        def make_input(n):
            rng = np.random.default_rng(n)
            return (rng.standard_normal((n, 1 << 15)).astype(np.float32),)

        rows = measure_scaling(make_fn, make_input, device_counts=[1, 2, 4, 8],
                               reps=2)
        assert [r["devices"] for r in rows] == [1, 2, 4, 8]
        assert rows[0]["efficiency"] == 1.0
        assert all(r["samples_per_s"] > 0 for r in rows)
        table = format_scaling_table(rows)
        assert "efficiency" in table and "8" in table


class TestOfdmFrameCapstone:
    def test_ofdm_frame_decode_time_sharded_matches_stream(self, mesh8):
        """COFDM capstone: whole-frame decode with symbol-aligned sharded
        demap equals the single-device stream decode."""
        from orion_sdr_tpu.parallel import ofdm_frame_decode_time_sharded
        from orion_sdr_tpu.multicarrier import CarrierPlan
        from orion_sdr_tpu.ofdm import OfdmConfig
        from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble

        plan = (CarrierPlan(256, 64)
                .with_pilot_carriers([(i, 1.0 + 0j)
                                      for i in range(-100, 101, 8)])
                .with_contiguous_data(edge_guard=27))
        cfg = OfdmConfig(plan, fs=1e6).with_equalizer_method("pilot_interp")
        table = sdr.McsTable.default_ladder()
        pre = OfdmPreamble(repeat_len=128, num_repeats=4
                           ).with_training_symbol(256, 64)
        rng = np.random.default_rng(21)
        payload = rng.integers(0, 256, 150).astype(np.uint8)
        iq = sdr.OfdmFrameMod(cfg, table, pre).modulate_frame(
            sdr.FramePacket(sdr.FrameMetadata(6, 2), payload), 3)
        h = np.zeros(6, np.complex64)
        h[0], h[3] = 1.0, 0.35 * np.exp(1j * 0.9)
        buf = np.convolve(np.concatenate(
            [np.zeros(800, np.complex64), iq]), h).astype(np.complex64)

        s = sdr.OfdmFrameStreamDemod(cfg, table, pre)
        res = s.feed(buf) + s.flush()
        single = [r.packet for r in res if hasattr(r, "packet")][0]

        pkt = ofdm_frame_decode_time_sharded(cfg, table, pre, buf, mesh8)
        assert np.array_equal(pkt.payload, single.payload)
        assert pkt.metadata.sequence_num == 6

    def test_ofdm_frame_capstone_training_hold_path(self, mesh8):
        from orion_sdr_tpu.parallel import ofdm_frame_decode_time_sharded
        from orion_sdr_tpu.multicarrier import CarrierPlan
        from orion_sdr_tpu.ofdm import OfdmConfig
        from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble

        plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
        cfg = OfdmConfig(plan, fs=1e6)
        table = sdr.McsTable.default_ladder()
        pre = OfdmPreamble(repeat_len=128, num_repeats=4
                           ).with_training_symbol(256, 64)
        rng = np.random.default_rng(22)
        payload = rng.integers(0, 256, 120).astype(np.uint8)
        iq = sdr.OfdmFrameMod(cfg, table, pre).modulate_frame(
            sdr.FramePacket(sdr.FrameMetadata(1, 1), payload), 9)
        buf = np.concatenate([np.zeros(333, np.complex64), iq])
        # the training-hold (default-equalizer) path
        # must run THROUGH the sharded demap — no single-device fallback
        from orion_sdr_tpu.parallel import sharding as _sh
        calls = []
        real = _sh.ofdm_soft_demap_sharded

        def counting(*a, **kw):
            calls.append(kw.get("estimate") is not None)
            return real(*a, **kw)

        _sh.ofdm_soft_demap_sharded = counting
        try:
            pkt = ofdm_frame_decode_time_sharded(cfg, table, pre, buf, mesh8)
        finally:
            _sh.ofdm_soft_demap_sharded = real
        assert np.array_equal(pkt.payload, payload)
        # header + payload both demapped sharded, with the held estimate in
        assert len(calls) == 2 and all(calls)


@pytest.mark.skipif(
    not os.environ.get("ORION_SDR_TPU_DISTRIBUTED"),
    reason="opt-in (ORION_SDR_TPU_DISTRIBUTED=1): spawns a 2-process "
           "jax.distributed cluster")
def test_two_process_distributed_smoke():
    """jax.distributed actually EXECUTES — two CPU
    processes join one cluster and ber_sharded's psum crosses them (gloo)."""
    import subprocess
    import sys
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run(
        [sys.executable, os.path.join(root, "tools", "distributed_smoke.py")],
        capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "distributed smoke: PASS" in r.stdout
