"""Benchmarks on one NVIDIA GPU: one JSON line per metric.

Per BASELINE.json: (1) FM broadcast chain, (2) PSK31 roundtrip, (3) FT8
batched-window receive, (4) COFDM frame decode chain, (5) DVB-T decode
chain, plus the COFDM TX chain and the mode-family programs. Reference
rates (``vs_baseline``) are BASELINE.md's Apple M2 Pro single-core figures.

    python bench.py               # every group, in order, in this process
    python bench.py --only dvb_t  # one group

Method: device programs are timed by looping them inside one jit
(lax.scan with a data-dependent carry, so XLA cannot collapse it) and
taking the median marginal cost between scan lengths; host stages (native
RS/BCH, Forney lines) are timed directly and composed with per-sample
weights into the chain numbers. Every line names the device it ran on; on
any backend but a GPU the bench refuses to run.
"""

import argparse
import json
import sys
import time

import numpy as np
import jax
import jax.numpy as jnp

_DEVICE: dict = {}


def _emit(metric, value, unit, baseline=None):
    """One JSON line per metric, naming the device. ``baseline``: the
    reference's rate for the same configuration (BASELINE.md), if any."""
    rec = {"metric": metric, "value": float(value), "unit": unit}
    if baseline is not None:
        rec["vs_baseline"] = float(value) / baseline
    rec.update(_DEVICE)
    print(json.dumps(rec), flush=True)


def _fetch(x):
    return float(jnp.sum(jnp.asarray(x)))


def _marginal_s(make_body, n_long=17, trials=5):
    """Median marginal seconds per body() application.

    ``make_body()`` → (body, carry0): body(carry) → carry, all jax arrays,
    data-dependent so the scan can't collapse."""
    body, carry0 = make_body()

    def runner(R):
        @jax.jit
        def f(c):
            out, _ = jax.lax.scan(lambda cc, _: (body(cc), 0.0), c, None,
                                  length=R)
            return jax.tree.map(jnp.sum, out)
        return f

    f1, fn = runner(1), runner(n_long)
    _fetch(jax.tree.leaves(f1(carry0))[0])
    _fetch(jax.tree.leaves(fn(carry0))[0])
    diffs = []
    for _ in range(trials):
        t0 = time.perf_counter()
        _fetch(jax.tree.leaves(f1(carry0))[0])
        d1 = time.perf_counter() - t0
        t0 = time.perf_counter()
        _fetch(jax.tree.leaves(fn(carry0))[0])
        dn = time.perf_counter() - t0
        diffs.append(dn - d1)
    return float(np.median(diffs)) / (n_long - 1)


def _slope_marginal_s(make, sizes, trials=9):
    """Device seconds per unit of size: the Theil–Sen slope (median of
    per-trial pairwise slopes) of t(size) over 3+ sizes, for programs that
    are not scan-replicated. ``make(size)`` → (jitted_f, args)."""
    fs = [make(s) for s in sizes]
    for f, args in fs:
        _fetch(f(*args))
    ts = [[] for _ in sizes]
    for _ in range(trials):
        for k, (f, args) in enumerate(fs):
            t0 = time.perf_counter()
            _fetch(f(*args))
            ts[k].append(time.perf_counter() - t0)
    x = np.asarray(sizes, np.float64)
    slopes = []
    for t in range(trials):
        for i in range(len(sizes)):
            for j in range(i + 1, len(sizes)):
                slopes.append((ts[j][t] - ts[i][t]) / (x[j] - x[i]))
    return max(float(np.median(slopes)), 1e-30)


def _size_marginal_s(make, size_small, size_big, trials=7):
    """Device seconds per unit of size: median(t(big)) − median(t(small))
    over size_big − size_small, so the fixed dispatch cost cancels.
    ``make(size)`` → (jitted_f, args)."""
    fs, args_s = make(size_small)
    fb, args_b = make(size_big)
    _fetch(fs(*args_s))
    _fetch(fb(*args_b))
    ds, db = [], []
    for _ in range(trials):
        t0 = time.perf_counter()
        _fetch(fs(*args_s))
        ds.append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        _fetch(fb(*args_b))
        db.append(time.perf_counter() - t0)
    d = float(np.median(db)) - float(np.median(ds))
    return max(d, 1e-30) / (size_big - size_small)


# ── 1. FM broadcast chain ────────────────────────────────────────────────────


def bench_fm():
    """FmQuadratureDemod equivalent: delay-conjugate discriminator
    (atan2_approx) → LR4 audio lowpass, 64ch (demodulate/fm.rs:12-90)."""
    from orion_sdr_tpu.dsp.iir import design_butter_lp, lp_cascade
    from orion_sdr_tpu.util import atan2_approx

    channels, n = 64, 1 << 20
    rng = np.random.default_rng(0)
    c = design_butter_lp(480e3, 5e3)
    k = np.float32(1.0 / 75e3)
    re = jnp.asarray(rng.standard_normal((channels, n)).astype(np.float32))
    im = jnp.asarray(rng.standard_normal((channels, n)).astype(np.float32))

    def make_body():
        def body(carry):
            r, i = carry
            z = r + 1j * i
            prev = jnp.concatenate([jnp.ones_like(z[..., :1]), z[..., :-1]],
                                   axis=-1)
            prod = z * jnp.conj(prev)
            disc = (atan2_approx(prod.imag, prod.real) * k
                    ).astype(jnp.float32)
            audio, _ = lp_cascade(disc, c)
            return (audio, i)        # data-dependent: audio feeds back
        return body, (re, im)

    per = _marginal_s(make_body, n_long=9)
    _emit("fm_demod_chain_throughput", channels * n / per / 1e6, "Msps",
          103.0)


# ── 2. PSK31 roundtrip ───────────────────────────────────────────────────────


def bench_psk31():
    """BPSK31 full roundtrip: bits → Hann-pulse DBPSK mod → decision-feedback
    MF demod + PLL, 16 channels (modulate/psk31.rs + demodulate/psk31.rs;
    baseline 678 Msps roundtrip)."""
    from orion_sdr_tpu.modulate.psk31 import psk31_sps, psk31_hann
    from orion_sdr_tpu.demodulate.psk31 import bpsk31_demod

    fs = 8000.0
    sps = psk31_sps(fs)
    channels, n_bits = 16, 2048
    rng = np.random.default_rng(1)
    bits = jnp.asarray(rng.integers(0, 2, (channels, n_bits)
                                    ).astype(np.uint8))
    h = jnp.asarray(psk31_hann(sps))

    def make_body():
        def body(carry):
            b, = carry
            # differential DBPSK phasors + Hann crossfade (the jnp form of
            # modulate/psk31.bpsk31_mod_bits, batched over channels)
            flips = jnp.cumsum(1 - (b & 1), axis=-1)
            phasors = jnp.where(flips % 2 == 1, -1.0, 1.0
                                ).astype(jnp.complex64)
            prev = jnp.concatenate(
                [jnp.ones_like(phasors[..., :1]), phasors[..., :-1]],
                axis=-1)
            seg = prev[..., None] * (1.0 - h) + phasors[..., None] * h
            iq = seg.reshape(seg.shape[0], -1).astype(jnp.complex64)
            soft = bpsk31_demod(iq, fs)
            nb = (soft >= 0).astype(jnp.uint8)
            return (jnp.roll(b ^ (nb[..., :n_bits] & 1), 1, axis=0),)
        return body, (bits,)

    per = _marginal_s(make_body, n_long=33, trials=7)
    samples = channels * n_bits * 256      # sps at 8 kHz
    _emit("psk31_roundtrip_throughput", samples / per / 1e6, "Msps", 678.0)


# ── 3. FT8 batched-window receive ────────────────────────────────────────────


def bench_ft8():
    """Device-side Msps of the fused many-window receive: waterfall +
    Costas score grid + top-k per window, plus the batched LDPC(174,91) BP
    on the candidates (sync/ft8_sync.rs + codec/ldpc.rs; baseline 35 Msps
    demod). B=2 windows of 15 s @ 12 kHz."""
    from orion_sdr_tpu.sync.ft8_sync import _sync_grid_device, _MODE
    from orion_sdr_tpu.codec.ft8_ldpc import ldpc_decode_soft

    fs, base_hz, max_hz = 12000.0, 200.0, 3000.0
    n, B, k = 180_000, 2, 4
    m = _MODE["ft8"]
    num_bins = int(np.ceil((max_hz - base_hz) / m["spacing"])) \
        + m["n_tones"] + 1
    rng = np.random.default_rng(2)
    re = jnp.asarray(rng.standard_normal((B, n)).astype(np.float32))
    im = jnp.asarray(rng.standard_normal((B, n)).astype(np.float32))
    llr = jnp.asarray(rng.standard_normal((B * k, 174)).astype(np.float32))

    # repetitions-marginal at fixed B; the LDPC argument is loop-carried so
    # XLA cannot hoist it out of the scan
    def make(reps):
        @jax.jit
        def f(r, i, l):
            def body(carry, _):
                rr, ii, ll, acc = carry
                wf, vals, idx = _sync_grid_device(
                    rr + 1j * ii, fs, base_hz, "ft8", num_bins,
                    m["total_syms"], 0, 0, k)
                bits, _ = ldpc_decode_soft(ll + 1e-9 * acc, 20)
                acc = acc + jnp.sum(vals) + jnp.sum(bits) + jnp.sum(wf)
                rr = jnp.roll(rr, 1, axis=0) + 1e-9 * acc
                return (rr, jnp.roll(ii, 1, axis=0), ll, acc), 0.0
            (_, _, _, acc), _ = jax.lax.scan(
                body, (r, i, l, jnp.float32(0)), None, length=reps)
            return acc
        return f, (re, im, llr)

    per_window = _size_marginal_s(make, 12, 1024, trials=9) / B
    _emit("ft8_batched_receive_throughput", n / per_window / 1e6, "Msps",
          35.0)


# ── 4. COFDM frame decode chain ──────────────────────────────────────────────


def _outer_decode_rate(t, blocks, k_bits, device_fn, native_fn):
    """Info bits/s of the outer decoder the chain picks for this batch
    (frame/chain.py::outer_on_device): the device program timed as a
    64-rep in-scan marginal on device-resident input, or the native host
    decoder by wall clock."""
    from orion_sdr_tpu.frame.chain import outer_on_device

    B = len(blocks)
    if outer_on_device(t, B):
        def make(nb):
            data = jnp.asarray(blocks[:nb])

            @jax.jit
            def f(d):
                def body(carry, _):
                    dd, acc = carry
                    out, okf = device_fn(dd)
                    acc = acc + jnp.sum(out) + jnp.sum(okf)
                    return (dd ^ (acc.astype(jnp.uint8) & 0), acc), 0.0
                (_, acc), _ = jax.lax.scan(
                    body, (d, jnp.int32(0)), None, length=64)
                return acc
            return f, (data,)
        return k_bits / (_size_marginal_s(make, B // 4, B) / 64)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        native_fn(blocks)
        best = min(best, time.perf_counter() - t0)
    return B * k_bits / best


def bench_cofdm():
    """COFDM LDPC+BCH frame decode chain: soft demap (device) + N512R12 BP
    at worst-case 50 iters (device) + shortened BCH t=8, composed
    sequentially with the link's per-sample weights
    (demodulate/ofdm_frame.rs; baseline ~58 Msps demod)."""
    from orion_sdr_tpu.multicarrier import CarrierPlan
    from orion_sdr_tpu.ofdm import OfdmConfig
    from orion_sdr_tpu.frame.demodulator import soft_demap
    from orion_sdr_tpu.fec.ldpc import ldpc_decode, ldpc_graph, ldpc_encode
    from orion_sdr_tpu.fec.bch_device import bch_decode_batch_device
    from orion_sdr_tpu.frame.chain import shortened_bch_for
    from orion_sdr_tpu import native

    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = OfdmConfig(plan, fs=1e6, constellation="qpsk")
    n_data = plan.num_data_carriers()
    sps = cfg.samples_per_ofdm_symbol()
    batch = 4
    rng = np.random.default_rng(3)
    REPS = 64          # in-scan repetitions of each device program

    def make_demap(n_sym):
        n = n_sym * sps
        re = jnp.asarray(rng.standard_normal((batch, n)).astype(np.float32))
        im = jnp.asarray(rng.standard_normal((batch, n)).astype(np.float32))

        @jax.jit
        def f(r, i):
            def body(carry, _):
                rr, ii, acc = carry
                llr = soft_demap(cfg, "qpsk", rr + 1j * ii, n_sym)
                acc = acc + jnp.sum(llr)
                return (jnp.roll(rr, 1, axis=0) + 1e-9 * acc,
                        jnp.roll(ii, 1, axis=0), acc), 0.0
            (_, _, acc), _ = jax.lax.scan(body, (r, i, jnp.float32(0)),
                                          None, length=REPS)
            return acc
        return f, (re, im)

    per_sym = _size_marginal_s(make_demap, 32, 1024) / REPS
    demap_rate = batch * sps / per_sym               # samples/s

    g = ldpc_graph("N512R12")

    def make_bp_rule(nb, rule):
        # decodable error-injected codewords (the reference's Rx
        # methodology), so the in-device early exit fires as it does at
        # the operating point
        msg = rng.integers(0, 2, (nb, g.k)).astype(np.uint8)
        cwb = np.asarray(ldpc_encode("N512R12", msg))
        llr_np = (1.0 - 2.0 * cwb).astype(np.float32) * 4.0
        for i in range(nb):
            pos = rng.choice(g.n, 6, replace=False)
            llr_np[i, pos] = -llr_np[i, pos]
        llr = jnp.asarray(llr_np)

        @jax.jit
        def f(l):
            def body(carry, _):
                ll, acc = carry
                bits, unsat = ldpc_decode("N512R12", ll, 50, rule)
                acc = acc + jnp.sum(unsat) + jnp.sum(bits)
                return (jnp.roll(ll, 1, axis=0) + 1e-9 * acc, acc), 0.0
            (_, acc), _ = jax.lax.scan(body, (l, jnp.float32(0)), None,
                                       length=REPS)
            return acc
        return f, (llr,)

    per_cw = _size_marginal_s(lambda nb: make_bp_rule(nb, "sum_product"),
                              512, 3072, trials=9) / REPS
    bp_coded_rate = g.n / per_cw                     # coded bits/s
    # the reference's fast decode rule (scaled min-sum α=0.75), emitted as
    # a second metric below
    per_cw_sms = _size_marginal_s(
        lambda nb: make_bp_rule(nb, "scaled_min_sum"), 512, 4096,
        trials=9) / REPS
    bp_coded_rate_sms = g.n / per_cw_sms

    # outer BCH at the chain's operating point (post-LDPC input is mostly
    # clean; 1 block in 8 carries 2 bit errors)
    bch = shortened_bch_for(8)
    msgs = rng.integers(0, 2, (4096, bch.k)).astype(np.uint8)
    bad = bch.encode(msgs).astype(np.uint8)
    for i in range(0, 4096, 8):
        bad[i, rng.choice(bch.n, 2, replace=False)] ^= 1
    bch_info_rate = _outer_decode_rate(
        8, bad[:2048], bch.k,
        lambda d: bch_decode_batch_device(bch.n, bch.k, 8, d),
        lambda b: native.bch_decode_batch(bch.n, bch.k, 8, b))

    # per-sample weights for this link (QPSK, LDPC r1/2, BCH 120/184)
    coded_per_sample = n_data * 2 / sps
    ldpc_info_per_sample = coded_per_sample * g.k / g.n
    bch_info_per_sample = ldpc_info_per_sample * bch.k / bch.n
    for metric, rate in (("cofdm_frame_decode_throughput", bp_coded_rate),
                         ("cofdm_frame_decode_throughput_sms",
                          bp_coded_rate_sms)):
        t_sample = (1.0 / demap_rate + coded_per_sample / rate
                    + bch_info_per_sample / bch_info_rate)
        _emit(metric, 1.0 / t_sample / 1e6, "Msps", 58.0)


# ── 5. DVB-T decode chain ────────────────────────────────────────────────────


def bench_dvb_t():
    """Conformant DVB-T decode chain, QPSK r1/2 GI 1/8: fused receive
    (FFT → scattered-pilot eq → extract → Figure-9a LLR + TPS, device) +
    chunked K=7 Viterbi (the chain's trellis decoder, device) + Forney lines
    (host) + RS(204,188) + TS, composed sequentially
    (demodulate/dvb_t_frame.rs; baseline ~13 Msps demod)."""
    from orion_sdr_tpu.demodulate.dvb_t_frame import _receive_frame_body
    from orion_sdr_tpu.fec.conv import viterbi_trellis
    from orion_sdr_tpu.fec.interleave import forney_deinterleave
    from orion_sdr_tpu.fec.galois import ReedSolomon
    from orion_sdr_tpu.fec.bch_device import rs_decode_batch_device
    from orion_sdr_tpu import native

    cp_len, vbits, B = 256, 2, 4
    sps = 2048 + cp_len
    rng = np.random.default_rng(4)

    def make_rx(n_symbols):
        n = n_symbols * sps
        re = jnp.asarray(rng.standard_normal((B, n)).astype(np.float32))
        im = jnp.asarray(rng.standard_normal((B, n)).astype(np.float32))

        @jax.jit
        def f(r, i):
            llrs, cells = _receive_frame_body(r + 1j * i, n_symbols, cp_len,
                                              0, vbits)
            return jnp.sum(llrs) + jnp.sum(jnp.abs(cells))
        return f, (re, im)

    per_sym_rx = _slope_marginal_s(make_rx, (68, 544, 1088, 1632), trials=13)
    rx_rate = B * sps / per_sym_rx                   # samples/s

    # chunked K=7 Viterbi: 256 chunk lanes × 1216-step trellis, through the
    # chain's own dispatch (fec/conv.py::viterbi_trellis)
    L, span, S = 256, 1216, 64
    c0 = jnp.asarray(rng.standard_normal((L, span)).astype(np.float32))
    c1 = jnp.asarray(rng.standard_normal((L, span)).astype(np.float32))
    pm0 = jnp.asarray(np.zeros((L, S), np.float32))

    def make_vit():
        def body(carry):
            a, b = carry
            bits = viterbi_trellis(a, b, pm0, "dvb_k7", terminated=False)
            bump = jnp.sum(bits).astype(jnp.float32) * 1e-6
            return (jnp.roll(a, 1, axis=0) + bump, jnp.roll(b, 1, axis=0))
        return body, (c0, c1)

    per_vit = _marginal_s(make_vit, n_long=49, trials=7)
    vit_info_rate = L * 1024 / per_vit               # trellis info bits/s

    # host stages: Forney lines + RS (error-injected) + dispersal
    byts = rng.integers(0, 256, 500_000).astype(np.uint8)
    best = np.inf
    for _ in range(3):
        t0 = time.perf_counter()
        forney_deinterleave(byts)
        best = min(best, time.perf_counter() - t0)
    forney_rate = len(byts) / best                   # bytes/s

    rs = ReedSolomon(204, 16)
    nbb = 2048
    msgs = rng.integers(0, 256, (nbb, 188)).astype(np.uint8)
    cw = np.stack([rs.encode(mm) for mm in msgs]).astype(np.uint8)
    for i in range(nbb):
        pos = rng.choice(204, 4, replace=False)
        cw[i, pos] ^= rng.integers(1, 256, 4).astype(np.uint8)
    rs_info_rate = _outer_decode_rate(
        8, cw, 188 * 8, lambda d: rs_decode_batch_device(204, 16, d),
        lambda b: native.rs_decode_batch(204, 16, b))

    # per-sample weights (1512 data cells × 2 bits / 2304 samples, r1/2)
    coded_per_sample = 1512 * vbits / sps
    vit_info_per_sample = coded_per_sample / 2
    bytes_per_sample = vit_info_per_sample / 8
    rs_info_per_sample = vit_info_per_sample * 188 / 204
    t_sample = (1.0 / rx_rate
                + vit_info_per_sample / vit_info_rate
                + bytes_per_sample / forney_rate
                + rs_info_per_sample / rs_info_rate)
    _emit("dvb_t_decode_chain_throughput", 1.0 / t_sample / 1e6, "Msps",
          13.0)


# ── 6. COFDM TX chain ────────────────────────────────────────────────────────


def bench_cofdm_tx():
    """COFDM frame-mod composite: device OFDM mod (256/64 QPSK, fused
    map_bits_grid path) + device LDPC N512R12 encode + BCH t=8 encode,
    composed sequentially with the link's per-sample weights — the richest
    TX chain (modulate/ofdm_frame.rs; baseline ~87 Msps)."""
    from orion_sdr_tpu.multicarrier import CarrierPlan
    from orion_sdr_tpu.ofdm import OfdmConfig, ofdm_mod
    from orion_sdr_tpu.fec.ldpc import ldpc_encode
    from orion_sdr_tpu.fec.bch_device import bch_encode_batch_device
    from orion_sdr_tpu.frame.chain import shortened_bch_for, outer_on_device

    rng = np.random.default_rng(7)
    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    cfg = OfdmConfig(plan, fs=1e6, constellation="qpsk")
    bps = cfg.bits_per_ofdm_symbol()
    sps = cfg.samples_per_ofdm_symbol()

    def make_mod(n_sym):
        bits = jnp.asarray(rng.integers(0, 2, (4, n_sym * bps)
                                        ).astype(np.uint8))

        @jax.jit
        def f(b):
            def body(carry, _):
                bb, acc = carry
                iq, _ = ofdm_mod(cfg, bb)
                acc = acc + jnp.sum(jnp.real(iq) ** 2)
                return (jnp.roll(bb, 1, axis=0), acc), 0.0
            (_, acc), _ = jax.lax.scan(body, (b, jnp.float32(0)), None,
                                       length=64)
            return acc
        return f, (bits,)

    mod_rate = 4 * sps / (_size_marginal_s(make_mod, 32, 4096, trials=9) / 64)

    def make_ldpc(B):
        m = jnp.asarray(rng.integers(0, 2, (B, 256)).astype(np.uint8))

        @jax.jit
        def f(x):
            def body(carry, _):
                xx, acc = carry
                cw = ldpc_encode("N512R12", xx)
                acc = acc + jnp.sum(cw.astype(jnp.int32))
                return (jnp.roll(xx, 1, axis=0)
                        ^ (acc.astype(jnp.uint8) & 0), acc), 0.0
            (_, acc), _ = jax.lax.scan(body, (x, jnp.int32(0)), None,
                                       length=128)
            return acc
        return f, (m,)

    ldpc_rate = 256 / (_size_marginal_s(make_ldpc, 1024, 8192, trials=9)
                       / 128)                         # info bits/s

    # outer BCH encode on the encoder the chain picks for a frame's batch
    bch = shortened_bch_for(8)
    if outer_on_device(8, 8192):
        def make_bch_enc(B):
            m = jnp.asarray(rng.integers(0, 2, (B, bch.k)).astype(np.uint8))

            @jax.jit
            def f(x):
                def body(carry, _):
                    xx, acc = carry
                    cw = bch_encode_batch_device(bch.n, bch.k, 8, xx)
                    acc = acc + jnp.sum(cw.astype(jnp.int32))
                    return (jnp.roll(xx, 1, axis=0)
                            ^ (acc.astype(jnp.uint8) & 0), acc), 0.0
                (_, acc), _ = jax.lax.scan(body, (x, jnp.int32(0)),
                                           None, length=128)
                return acc
            return f, (m,)

        bch_rate = bch.k / (_size_marginal_s(make_bch_enc, 1024, 8192,
                                             trials=9) / 128)
    else:
        bbits = rng.integers(0, 2, (8192, bch.k)).astype(np.uint8)
        best = np.inf
        bch.encode(bbits)
        for _ in range(3):
            t0 = time.perf_counter()
            bch.encode(bbits)
            best = min(best, time.perf_counter() - t0)
        bch_rate = 8192 * bch.k / best               # info bits/s

    coded_per_sample = plan.num_data_carriers() * 2 / sps
    ldpc_info_ps = coded_per_sample * 0.5
    bch_info_ps = ldpc_info_ps * bch.k / bch.n
    t_sample = (1.0 / mod_rate + ldpc_info_ps / ldpc_rate
                + bch_info_ps / bch_rate)
    _emit("cofdm_frame_mod_throughput", 1.0 / t_sample / 1e6, "Msps", 87.0)


# ── 7. Beyond-reference mode families ───────────────────────────────────────
# One marginal-cost metric per mode family. These programs have no
# reference counterpart, so their lines carry no vs_baseline.


def _roll_body(rate_fn, *carry0):
    """Standard data-dependent scan body over (re, im, acc)."""
    def make():
        def body(carry):
            r, i, acc = carry
            acc = acc + rate_fn(r, i)
            return (jnp.roll(r, 1, axis=0) + 1e-12 * acc,
                    jnp.roll(i, 1, axis=0), acc)
        return body, (*carry0, jnp.float32(0))
    return make


def _family(name):
    """The family bench ``name`` (e.g. "pfb"), a zero-argument callable."""
    rng = np.random.default_rng(11)

    def fam_pfb():
        from orion_sdr_tpu.dsp.pfb import pfb_prototype, _pfb_run
        C, n = 64, 1 << 20
        proto = jnp.asarray(pfb_prototype(C))
        re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        im = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        make = _roll_body(
            lambda r, i: jnp.sum(jnp.abs(_pfb_run(r + 1j * i, proto, C))),
            re, im)
        _emit("pfb_channelizer_throughput",
              n / _marginal_s(make, n_long=385, trials=5) / 1e6, "Msps")

    def fam_css():
        from orion_sdr_tpu.demodulate.css import _dechirp_fft, _base
        sf, bw = 9, 125_000.0
        spsym, m_, n_sym = 1 << sf, 1 << sf, 128
        n = n_sym * spsym
        up_re, up_im = _base(sf, bw, bw)
        ur, ui = jnp.asarray(up_re), jnp.asarray(up_im)
        re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        im = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        make = _roll_body(
            lambda r, i: jnp.sum(_dechirp_fft(r + 1j * i, ur, ui,
                                              n_sym, spsym, m_)),
            re, im)
        _emit("css_dechirp_throughput",
              n / _marginal_s(make, n_long=1025, trials=5) / 1e6, "Msps")

    def fam_wspr():
        from orion_sdr_tpu.demodulate.wspr import _energy_grid
        from orion_sdr_tpu.codec.wspr import WSPR_SPS, WSPR_SYMBOLS, WSPR_FS
        n = WSPR_SYMBOLS * WSPR_SPS + 4 * WSPR_SPS
        dts = tuple(int(d) for d in np.arange(-4, 5) * (WSPR_SPS // 8))
        dfs = np.linspace(-2.0, 2.0, 7)
        re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        im = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        make = _roll_body(
            lambda r, i: jnp.sum(_energy_grid.__wrapped__(
                r, i, dts, dfs, WSPR_FS, 1500.0)),
            re, im)
        _emit("wspr_energy_grid_throughput",
              n / _marginal_s(make, n_long=1025, trials=5) / 1e6, "Msps")

    def fam_stereo():
        from orion_sdr_tpu.demodulate.fm_stereo import _stereo_device
        fs, n = 240_000.0, 1 << 17
        re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        im = jnp.asarray(rng.standard_normal(n).astype(np.float32))

        def rate_fn(r, i):
            mono, sub, pil, rbb = _stereo_device.__wrapped__(
                r, i, fs, 75e3, 15e3, 0.45, True)
            return (jnp.sum(mono) + jnp.sum(sub) + jnp.sum(rbb)
                    + jnp.sum(pil))
        make = _roll_body(rate_fn, re, im)
        _emit("fm_stereo_rds_throughput",
              n / _marginal_s(make, n_long=17, trials=5) / 1e6, "Msps")

    def fam_fsk2():
        from orion_sdr_tpu.demodulate.afsk import fsk2_decision
        fs, n, Bc = 48_000.0, 1 << 18, 4
        sps = int(fs / 1200.0)
        x = jnp.asarray(rng.standard_normal((Bc, n)).astype(np.float32))

        def make():
            def body(carry):
                xx, acc = carry
                acc = acc + jnp.sum(fsk2_decision(xx, fs, sps))
                return (jnp.roll(xx, 1, axis=0) + 1e-12 * acc, acc)
            return body, (x, jnp.float32(0))
        _emit("fsk2_engine_throughput",
              Bc * n / _marginal_s(make, n_long=65, trials=7) / 1e6, "Msps")

    def fam_gnss():
        from orion_sdr_tpu.gnss import _acquire_grid, _ca_pm_sampled
        fs, n_blocks, n_prn = 2_048_000.0, 4, 32
        spms = 2048
        codes = jnp.asarray(np.stack([_ca_pm_sampled(p, fs)
                                      for p in range(1, n_prn + 1)]))
        dopp = jnp.asarray(np.arange(-5000.0, 5001.0, 250.0, np.float32))
        n = (n_blocks + 1) * spms
        re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        im = jnp.asarray(rng.standard_normal(n).astype(np.float32))
        make = _roll_body(
            lambda r, i: jnp.sum(_acquire_grid(r + 1j * i, codes, dopp,
                                               fs, n_blocks)),
            re, im)
        cells = n_prn * int(dopp.shape[0]) * spms
        _emit("gnss_acquisition_throughput",
              cells / _marginal_s(make, n_long=33, trials=5) / 1e6, "Msps")

    def fam_burst():
        from orion_sdr_tpu.modulate.digital import rrc_taps
        from orion_sdr_tpu.dsp.fir import fir_filter_aligned
        from orion_sdr_tpu.demodulate.digital import _dd_pll_kernel
        sps, n_sym, Bc = 8, 2048, 4
        n = n_sym * sps
        taps = rrc_taps(sps, 0.35, 8)
        re = jnp.asarray(rng.standard_normal((Bc, n)).astype(np.float32))
        im = jnp.asarray(rng.standard_normal((Bc, n)).astype(np.float32))

        def rate_fn(r, i):
            zf = fir_filter_aligned(r + 1j * i, taps)
            grid = zf[..., : n_sym * sps].reshape(Bc, n_sym, sps)
            e = jnp.mean(jnp.abs(grid) ** 2, axis=1)
            ph = jnp.argmax(e, axis=-1)
            syms = jnp.take_along_axis(
                grid, ph[:, None, None], axis=-1)[..., 0]
            y = jax.vmap(lambda s: _dd_pll_kernel.__wrapped__(
                s.real, s.imag, "qam16", 0.03))(syms)
            return jnp.sum(jnp.abs(y))
        make = _roll_body(rate_fn, re, im)
        _emit("burst_modem_throughput",
              Bc * n / _marginal_s(make, n_long=41, trials=5) / 1e6, "Msps")

    def fam_hier():
        from orion_sdr_tpu.demodulate.dvb_t_frame import _receive_frame_body
        cp_len, vbits, alpha, Bc = 256, 4, 2, 4
        sps = 2048 + cp_len

        def make(n_symbols):
            nn = n_symbols * sps
            re = jnp.asarray(rng.standard_normal((Bc, nn)
                                                 ).astype(np.float32))
            im = jnp.asarray(rng.standard_normal((Bc, nn)
                                                 ).astype(np.float32))

            @jax.jit
            def f(r, i):
                llrs, cells = _receive_frame_body(
                    r + 1j * i, n_symbols, cp_len, 0, vbits, alpha)
                return jnp.sum(llrs) + jnp.sum(jnp.abs(cells))
            return f, (re, im)

        per_sym = _slope_marginal_s(make, (68, 544, 1088, 1632), trials=13)
        _emit("dvb_t_hier_receive_throughput", Bc * sps / per_sym / 1e6,
              "Msps")

    def fam_gnss_track():
        # E/P/L Costas PLL + DLL scan, 8 satellites vmapped over one
        # 2.048 MHz capture; n_epochs size-marginal (epochs are sequential)
        from orion_sdr_tpu.gnss import _track_scan, _ca_pm_sampled
        fs, n_sat = 2_048_000.0, 8
        spms = 2048
        codes = jnp.asarray(np.stack([_ca_pm_sampled(p, fs)
                                      for p in range(1, n_sat + 1)]))
        starts = jnp.asarray(np.full(n_sat, 8, np.int32))
        f0s = jnp.asarray(np.linspace(-3000, 3000, n_sat, dtype=np.float32))

        def make(n_epochs):
            n = (n_epochs + 2) * spms
            re = jnp.asarray(rng.standard_normal(n).astype(np.float32))
            im = jnp.asarray(rng.standard_normal(n).astype(np.float32))

            @jax.jit
            def f(r, i):
                z = r + 1j * i
                prompts, freqs, bases, fracs = jax.vmap(
                    lambda c, s, f0: _track_scan.__wrapped__(
                        z, c, s, f0, fs, n_epochs, 7.2, 0.9, 0.12)
                )(codes, starts, f0s)
                return (jnp.sum(jnp.abs(prompts)) + jnp.sum(freqs)
                        + jnp.sum(fracs))
            return f, (re, im)

        per_epoch = _size_marginal_s(make, 100, 2000, trials=7)
        # per-satellite samples tracked per second, summed over the bank
        _emit("gnss_tracking_throughput", n_sat * spms / per_epoch / 1e6,
              "Msps")

    return locals()[f"fam_{name}"]


# group → (runner, metrics it emits), in record order
GROUPS = [
    ("fm", bench_fm, ["fm_demod_chain_throughput"]),
    ("psk31", bench_psk31, ["psk31_roundtrip_throughput"]),
    ("ft8", bench_ft8, ["ft8_batched_receive_throughput"]),
    ("cofdm", bench_cofdm, ["cofdm_frame_decode_throughput",
                            "cofdm_frame_decode_throughput_sms"]),
    ("dvb_t", bench_dvb_t, ["dvb_t_decode_chain_throughput"]),
    ("cofdm_tx", bench_cofdm_tx, ["cofdm_frame_mod_throughput"]),
] + [(name, _family(name), [metric]) for name, metric in (
    ("pfb", "pfb_channelizer_throughput"),
    ("css", "css_dechirp_throughput"),
    ("wspr", "wspr_energy_grid_throughput"),
    ("stereo", "fm_stereo_rds_throughput"),
    ("fsk2", "fsk2_engine_throughput"),
    ("gnss", "gnss_acquisition_throughput"),
    ("burst", "burst_modem_throughput"),
    ("hier", "dvb_t_hier_receive_throughput"),
    ("gnss_track", "gnss_tracking_throughput"),
)]


def device_fields() -> dict:
    """The device every line names; raises SystemExit off the GPU."""
    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{devs[0].platform} ({devs[0].device_kind})")
    return {"platform": devs[0].platform, "device_kind": devs[0].device_kind,
            "device_count": len(devs)}


def run_groups(groups) -> bool:
    """Run each group in order in this process. A group that raises gets an
    error line per metric and the others still run. True if all landed."""
    ok = True
    for name, fn, metrics in groups:
        try:
            fn()
        except Exception as e:                            # noqa: BLE001
            ok = False
            for m in metrics:
                print(json.dumps({"metric": m, "error": f"{type(e).__name__}:"
                                  f" {e}"[:300], **_DEVICE}), flush=True)
    return ok


def main(argv=None) -> None:
    names = [g[0] for g in GROUPS]
    ap = argparse.ArgumentParser(description="GPU benchmarks, one JSON line "
                                             "per metric")
    ap.add_argument("--only", choices=names, metavar="GROUP",
                    help="run one group: " + ", ".join(names))
    args = ap.parse_args(argv)
    _DEVICE.update(device_fields())
    from orion_sdr_tpu.runtime import use_compile_cache
    use_compile_cache()
    groups = [g for g in GROUPS if args.only in (None, g[0])]
    if not run_groups(groups):
        sys.exit(1)


if __name__ == "__main__":
    main()
