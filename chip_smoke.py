#!/usr/bin/env python3
"""Start-up proof on one NVIDIA GPU: the DVB-T receive chain (the main
path), the COFDM and FT8 chains and the hand-written kernel, run through
the library's own entry points and checked against its plain references.

    python chip_smoke.py            # one GPU, every phase below
    python chip_smoke.py --multi    # four GPUs: the sharded paths only

Phases (any failure exits non-zero before the last line is printed):
  0 device   GPU present; card name and power limit; JAX version; compile
             cache; native RS/BCH library loaded
  1 parity   Viterbi kernel vs the plain scan at the DVB-T chunk widths and
             on terminated trellises; LDPC BP gather form vs the one-hot
             form at B=1024, every rule
  2 DVB-T    one super-frame (4 frames x 68 symbols, 2K) in two link modes,
             streamed in uneven chunks and batch-decoded: TS packets equal
  3 COFDM    N512R12 LDPC + BCH t=8 frames, sum-product and scaled min-sum
  4 FT8      4 windows x 10 signals, batched and multi-signal decode
  5 memory   peak device memory; memory analysis of the fused DVB-T receive

The last line of standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))


def log(msg: str) -> None:
    print(msg, flush=True)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    raise SystemExit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


def awgn(rng, x, snr_db: float, ref_power: float | None = None):
    """x plus complex white noise ``snr_db`` below ``ref_power`` (default:
    x's mean power)."""
    p = float(np.mean(np.abs(x) ** 2)) if ref_power is None else ref_power
    sigma = np.sqrt(p / 10 ** (snr_db / 10) / 2)
    n = rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape)
    return (x + sigma * n).astype(np.complex64)


# ── phase 0 ──────────────────────────────────────────────────────────────────


def phase_device(n_devices: int):
    import jax
    from orion_sdr_tpu.runtime import use_compile_cache
    from orion_sdr_tpu import native

    devs = jax.devices()
    if not devs or devs[0].platform != "gpu":
        fail(f"no GPU: JAX found {[d.platform for d in devs]}")
    check(len(devs) >= n_devices,
          f"need {n_devices} GPUs, JAX found {len(devs)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    for line in smi.stdout.strip().splitlines():
        log(f"[device] nvidia-smi: {line.strip()}")
    log(f"[device] jax {jax.__version__}, {len(devs)} x "
        f"{devs[0].device_kind}")
    log(f"[device] compile cache: {use_compile_cache()}")
    check(native.AVAILABLE, "native RS/BCH library did not load")
    log("[device] native RS/BCH library: loaded")
    return devs


# ── phase 1 ──────────────────────────────────────────────────────────────────


def phase_parity():
    import jax
    from orion_sdr_tpu.fec.conv import (CONV_CODES, _trellis_scan, _tables,
                                        viterbi_trellis, _CHUNK_STEPS,
                                        _CHUNK_OVERLAP)
    from orion_sdr_tpu.ops.viterbi import trellis_impl

    rng = np.random.default_rng(1)
    scan = jax.jit(_trellis_scan, static_argnums=(3, 4))
    span = _CHUNK_STEPS + 2 * _CHUNK_OVERLAP
    cases = [("dvb_k7", L, span, False) for L in (101, 402, 1608)]
    cases += [("dvb_k7", 64, 206, True), ("dvb_k7", 64, 4102, True),
              ("k5", 64, 204, True), ("k5", 64, 4100, True)]
    log("[parity] Viterbi kernel vs plain scan, both on the GPU, float32 "
        "path metrics; tolerance: bit-exact")
    for code, L, T, term in cases:
        K = CONV_CODES[code]["K"]
        impl = trellis_impl(T, K)
        check(impl == "cuda", f"trellis of {T} steps took {impl}")
        S = _tables(code)[1]
        if term:
            pm0 = np.full((L, S), -1e30, np.float32)
            pm0[:, 0] = 0.0
        else:
            pm0 = rng.standard_normal((L, S)).astype(np.float32)
        for kind in ("integer", "gaussian"):
            if kind == "integer":
                l0 = rng.integers(-8, 9, (L, T)).astype(np.float32)
                l1 = rng.integers(-8, 9, (L, T)).astype(np.float32)
            else:
                l0 = (rng.standard_normal((L, T)) * 3).astype(np.float32)
                l1 = (rng.standard_normal((L, T)) * 3).astype(np.float32)
            got = np.asarray(jax.jit(viterbi_trellis, static_argnums=(3, 4))(
                l0, l1, pm0, code, term))
            ref = np.asarray(scan(l0, l1, pm0, code, term))
            flips = int(np.sum(got != ref))
            log(f"[parity] viterbi {code} L={L} T={T} "
                f"{'terminated' if term else 'chunked'} {kind} LLRs: "
                f"{impl}, {flips} differing bits of {got.size}")
            check(flips == 0, f"Viterbi kernel differs from the scan "
                  f"({code}, L={L}, T={T}, {kind})")

    from orion_sdr_tpu.fec.ldpc import ldpc_graph, ldpc_encode, bp_decode
    from orion_sdr_tpu.codec.ft8_ldpc import ft8_ldpc_graph
    from orion_sdr_tpu.codec import ft8_ldpc
    from tools.bp_onehot import bp_decode_onehot

    B = 1024
    g = ldpc_graph("N512R12")
    msg = rng.integers(0, 2, (B, g.k)).astype(np.uint8)
    cw = np.asarray(ldpc_encode("N512R12", msg))
    g8 = ft8_ldpc_graph()
    m8 = rng.integers(0, 2, (B, 91)).astype(np.uint8)
    c8 = np.asarray(ft8_ldpc.ldpc_encode(m8))
    log("[parity] LDPC BP gather form (the library's) vs the one-hot form "
        "(tools/bp_onehot.py, matmuls at Precision.HIGHEST), both on the "
        "GPU, float32, B=1024 noisy codewords; tolerance: equal decoded "
        "codewords and unsat counts, every codeword the one sent")
    for name, graph, ref_msg, code in (("N512R12", g, msg, cw),
                                       ("FT8(174,91)", g8, m8, c8)):
        llr = (np.where(code == 0, 2.0, -2.0)
               + rng.standard_normal(code.shape) * 0.9).astype(np.float32)
        for rule in ("sum_product", "min_sum", "scaled_min_sum"):
            bits, unsat = map(np.asarray, bp_decode(graph, llr, 50, rule,
                                                    0.75))
            rbits, runsat = map(np.asarray, bp_decode_onehot(
                graph, llr, 50, rule, 0.75))
            n_diff = int(np.sum(np.any(bits != rbits, axis=1)
                                | (unsat != runsat)))
            log(f"[parity] BP {name} {rule} B={B}: {int(np.sum(unsat == 0))}"
                f" decoded, {int(np.sum(np.all(bits == ref_msg, axis=1)))} "
                f"equal to the message sent, {n_diff} codewords differ "
                f"from the one-hot form")
            check(n_diff == 0, f"BP gather form differs from the one-hot "
                  f"form ({name}, {rule})")
            check((unsat == 0).all() and np.array_equal(bits, ref_msg),
                  f"BP failed ({name}, {rule})")


# ── phase 2 ──────────────────────────────────────────────────────────────────

DVB_T_MODES = (
    # (guard, constellation, code rate, SNR dB): waterline + margin —
    # QPSK r1/2 decodes from 4 dB (docs/sweeps.md); 64-QAM r2/3 needs about
    # 16.5 dB (EN 300 744 Annex A, Gaussian channel)
    ("1/8", "qpsk", "1/2", 8.0),
    ("1/4", "qam64", "2/3", 22.0),
)


def _packets_per_frame(params) -> int:
    """Most TS packets a 68-symbol frame carries."""
    from orion_sdr_tpu.modulate.dvb_t_frame import _coded_bits_for_packets
    from orion_sdr_tpu.constellation import BITS_PER_SYMBOL
    from orion_sdr_tpu.waveform.dvb_t import DVB_T_DATA_CARRIERS
    cap = 68 * DVB_T_DATA_CARRIERS * BITS_PER_SYMBOL[
        params.link.constellation]
    n = 1
    while _coded_bits_for_packets(n + 1, params) <= cap:
        n += 1
    return n


def dvb_t_capture(guard: str, const: str, rate: str, snr: float):
    """One full super-frame of seeded TS packets in one link mode, behind a
    seeded leading offset, in AWGN → (super-frame params, modulated
    super-frame, payload, TS packets per frame, offset, capture)."""
    from orion_sdr_tpu.waveform.dvb_t import (DvbTLinkParams,
                                              DvbTSuperFrameParams)
    from orion_sdr_tpu.waveform.dvb_t_ts import TS_PAYLOAD_LEN
    from orion_sdr_tpu.modulate.dvb_t_super_frame import DvbTSuperFrameMod

    rng = np.random.default_rng(2)
    sp = DvbTSuperFrameParams(DvbTLinkParams(guard, const, rate),
                              cell_id=0x2A5F)
    n_pkt = _packets_per_frame(sp.frame(0))
    payload = rng.integers(0, 256, 4 * n_pkt * TS_PAYLOAD_LEN).astype(
        np.uint8)
    sf = DvbTSuperFrameMod(sp).modulate(payload)
    lead = int(rng.integers(0, sf.samples_per_symbol // 2))
    cap = np.concatenate([np.zeros(lead, np.complex64), sf.iq,
                          np.zeros(sf.samples_per_symbol, np.complex64)])
    return sp, sf, payload, n_pkt, lead, awgn(rng, cap, snr)


def dvb_t_stream(sp, sf, n_pkt: int, cap):
    """``DvbTFrameStreamDemod.feed``/``flush`` over ``cap`` in uneven
    chunks → every result (frames and errors)."""
    from orion_sdr_tpu.waveform.dvb_t_ts import TS_PAYLOAD_LEN
    from orion_sdr_tpu.demodulate.dvb_t_stream import DvbTFrameStreamDemod

    st = DvbTFrameStreamDemod(sp.frame(0), sf.symbols_per_frame,
                              n_pkt * TS_PAYLOAD_LEN)
    out, pos = [], 0
    crng = np.random.default_rng(3)
    while pos < len(cap):
        n = int(crng.integers(10_000, 200_000))
        out += st.feed(cap[pos:pos + n])
        pos += n
    return out + st.flush()


def phase_dvb_t():
    from orion_sdr_tpu.waveform.dvb_t import (dvb_t_frame_outer,
                                              dvb_t_frame_outer_il)
    from orion_sdr_tpu.waveform.dvb_t_ts import TS_PAYLOAD_LEN, TS_PACKET_LEN
    from orion_sdr_tpu.frame.chain import block_plan
    from orion_sdr_tpu.frame.types import InterleaverKind
    from orion_sdr_tpu.demodulate.dvb_t_super_frame import DvbTSuperFrameDemod
    from orion_sdr_tpu.fec.conv import _CHUNK_STEPS, _CHUNK_OVERLAP
    from orion_sdr_tpu.ops.viterbi import trellis_impl
    from orion_sdr_tpu.frame.chain import outer_on_device

    for guard, const, rate, snr in DVB_T_MODES:
        sp, sf, payload, n_pkt, lead, cap = dvb_t_capture(guard, const, rate,
                                                          snr)
        check(sf.symbols_per_frame == 68,
              f"frame is {sf.symbols_per_frame} symbols")
        per_frame = n_pkt * TS_PAYLOAD_LEN
        mode = f"{const} r{rate} GI {guard} @ {snr:g} dB"
        plan = block_plan(n_pkt * TS_PACKET_LEN, "none", dvb_t_frame_outer(),
                          sp.frame(0).inner(), dvb_t_frame_outer_il(),
                          InterleaverKind.none())
        lanes = -(-(plan.outer_il_bits + 6) // _CHUNK_STEPS)
        log(f"[dvb-t] {mode}: {n_pkt} TS packets/frame, offset {lead}, "
            f"{lanes} Viterbi chunk lanes/frame; receive: XLA; Viterbi: "
            f"{trellis_impl(_CHUNK_STEPS + 2 * _CHUNK_OVERLAP, 7)}; Forney: "
            f"host; RS(204,188): "
            f"{'device' if outer_on_device(8, n_pkt) else 'native host'}")

        def batch():
            return DvbTSuperFrameDemod(sp).decode_batch(
                cap, sf.symbols_per_frame, sf.frame_payload_lens)

        for name, run in (("stream",
                           lambda: dvb_t_stream(sp, sf, n_pkt, cap)),
                          ("decode_batch", batch)):
            t0 = time.perf_counter()
            res = run()
            cold = time.perf_counter() - t0
            t0 = time.perf_counter()
            res = run()
            warm = time.perf_counter() - t0
            if name == "stream":
                frames = [r for r in res if hasattr(r, "payload")]
                check(len(frames) == 4 and len(res) == 4,
                      f"{mode} stream: {len(frames)}/4 frames, {res}")
                for f, r in enumerate(frames):
                    check(np.array_equal(
                        r.payload, payload[f * per_frame:(f + 1) * per_frame]),
                        f"{mode} stream frame {f}: TS packets differ")
                    check(r.tps.frame_number == f and
                          r.tps.constellation == const,
                          f"{mode} stream frame {f}: TPS {r.tps}")
            else:
                check(np.array_equal(res.payload, payload),
                      f"{mode} decode_batch: TS packets differ")
                check(res.cell_id == 0x2A5F, f"cell id {res.cell_id:#x}")
            log(f"[dvb-t] {mode} {name}: 4 frames, {4 * n_pkt} TS packets "
                f"equal; first run {cold:.2f} s, warm {warm / 4 * 1e3:.1f} "
                f"ms/frame (information, host clock)")


# ── phase 3 ──────────────────────────────────────────────────────────────────


# the stream receiver drops the first of several frames at 16 dB (seeded
# case, CPU and GPU alike), so the smoke runs well clear of that
COFDM_SNR_DB = 25.0


def cofdm_link(rule: str):
    """The smoke's COFDM link: QPSK, N512R12 LDPC decoded with ``rule``,
    BCH t=8 → (config, MCS table, preamble)."""
    from orion_sdr_tpu.multicarrier import CarrierPlan
    from orion_sdr_tpu.ofdm import OfdmConfig
    from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble
    from orion_sdr_tpu.frame import InnerFec, OuterFec, Mcs, McsTable

    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    pre = OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        plan.n_fft, plan.cp_len)
    table = McsTable([Mcs("qpsk", InnerFec.ldpc("N512R12"), OuterFec.bch(8))])
    return OfdmConfig(plan, fs=1e6).with_ldpc_decode_rule(rule), table, pre


def cofdm_capture(cfg, table, pre, rng):
    """Four 1500-byte frames with gaps, AWGN at COFDM_SNR_DB on the data
    symbols → (capture, [(metadata, payload)])."""
    from orion_sdr_tpu.frame import FramePacket, FrameMetadata, OfdmFrameMod

    mod = OfdmFrameMod(cfg, table, pre)
    sent, body_power = [], []
    parts = [np.zeros(3000, np.complex64)]
    for i in range(4):
        meta = FrameMetadata(sequence_num=100 + i, mcs_index=0, flags=i)
        data = rng.integers(0, 256, 1500).astype(np.uint8)
        sent.append((meta, data))
        iq = mod.modulate_frame(FramePacket(meta, data), 0x1000 + i)
        body_power.append(np.mean(np.abs(iq[pre.total_len():]) ** 2))
        parts += [iq, np.zeros(2500, np.complex64)]
    # SNR on the data symbols (the preamble runs ~23 dB hotter)
    cap = awgn(rng, np.concatenate(parts), COFDM_SNR_DB,
               float(np.mean(body_power)))
    return cap, sent


def cofdm_stream(cfg, table, pre, cap, seed: int = 7):
    """``OfdmFrameStreamDemod.feed``/``flush`` over ``cap`` in uneven
    chunks → the decoded packets."""
    from orion_sdr_tpu.frame import OfdmFrameStreamDemod

    rng = np.random.default_rng(seed)
    st = OfdmFrameStreamDemod(cfg, table, pre)
    res, pos = [], 0
    while pos < len(cap):
        n = int(rng.integers(5_000, 40_000))
        res += st.feed(cap[pos:pos + n])
        pos += n
    res += st.flush()
    return [r.packet for r in res if hasattr(r, "packet")], res


def phase_cofdm():
    log(f"[cofdm] QPSK N512R12 LDPC + BCH t=8 @ {COFDM_SNR_DB:g} dB; "
        f"BP: XLA gather form")
    for rule in ("sum_product", "scaled_min_sum"):
        cfg, table, pre = cofdm_link(rule)
        cap, sent = cofdm_capture(cfg, table, pre, np.random.default_rng(4))
        t0 = time.perf_counter()
        got, res = cofdm_stream(cfg, table, pre, cap)
        dt = time.perf_counter() - t0
        check(len(got) == 4, f"cofdm {rule}: {len(got)}/4 frames: {res}")
        for (meta, data), p in zip(sent, got):
            check(np.array_equal(p.payload, data), f"cofdm {rule}: payload")
            check((p.metadata.sequence_num, p.metadata.mcs_index,
                   p.metadata.flags) == (meta.sequence_num, meta.mcs_index,
                                         meta.flags),
                  f"cofdm {rule}: metadata {p.metadata}")
        log(f"[cofdm] {rule}: 4 frames, payloads and metadata equal "
            f"({dt:.2f} s including compiles)")


# ── phase 4 ──────────────────────────────────────────────────────────────────

FT8_FS = 12000.0


def ft8_windows(rng, n_win: int = 4, n_sig: int = 10):
    """``n_win`` 15 s windows at 12 kHz, each with ``n_sig`` CQ messages at
    -10..+10 dB in unit-power noise → (windows, sent callsigns per window,
    hash table)."""
    from orion_sdr_tpu.modulate.ft8 import ft8_mod
    from orion_sdr_tpu.codec.ft8 import ft8_encode
    from orion_sdr_tpu.message import pack77, Standard, CallsignHashTable

    fs, win_len = FT8_FS, 180_000
    ht = CallsignHashTable()
    letters = "ABCDEFGHIJKLMNOPQRSTUVWXYZ"
    windows = np.zeros((n_win, win_len), np.complex64)
    sent = []
    for w in range(n_win):
        calls = set()
        freqs = 300.0 + 250.0 * np.arange(n_sig) + \
            6.25 * rng.integers(0, 8, n_sig)
        snrs = rng.uniform(-10.0, 10.0, n_sig)
        for f0, snr in zip(freqs, snrs):
            call = "K" + str(int(rng.integers(0, 10))) + "".join(
                rng.choice(list(letters), 3))
            grid = "".join(rng.choice(list("ABCDEFGHIJKLMNOPQR"), 2)) + \
                str(int(rng.integers(0, 100))).zfill(2)
            calls.add(call)
            p = pack77(Standard("CQ", call, grid), ht)
            sig = np.asarray(ft8_mod(ft8_encode(p), fs, base_hz=float(f0)))
            # unit-power noise below; SNR in the 2500 Hz reference band
            amp = np.sqrt(10 ** (snr / 10) * 2500.0 / fs)
            windows[w, :len(sig)] += (amp * sig).astype(np.complex64)
        sent.append(calls)
    windows += ((rng.standard_normal(windows.shape)
                 + 1j * rng.standard_normal(windows.shape))
                / np.sqrt(2)).astype(np.complex64)
    return windows, sent, ht


def phase_ft8():
    from orion_sdr_tpu.codec.ft8_stream import (ft8_decode_windows,
                                                ft8_decode_multi_signal)

    windows, sent, ht = ft8_windows(np.random.default_rng(5))
    n_win, fs = len(windows), FT8_FS
    t0 = time.perf_counter()
    first = ft8_decode_windows(windows, fs, 200.0, 3000.0, max_cand=16,
                               hash_table=ht)
    dt = time.perf_counter() - t0
    for w, r in enumerate(first):
        check(r is not None and r.message.call_de in sent[w],
              f"ft8_decode_windows window {w}: {r}")
    log(f"[ft8] ft8_decode_windows: {n_win} windows, each window's first "
        f"decode is a sent message ({dt:.2f} s including compiles)")
    t0 = time.perf_counter()
    for w in range(n_win):
        got = {r.message.call_de for r in ft8_decode_multi_signal(
            windows[w], fs, 200.0, 3000.0, max_cand=16, hash_table=ht)}
        check(sent[w] <= got, f"ft8 window {w}: missed {sent[w] - got}")
    dt = time.perf_counter() - t0
    log(f"[ft8] ft8_decode_multi_signal: all "
        f"{sum(len(c) for c in sent)} messages (-10..+10 dB) decoded "
        f"({dt:.2f} s including compiles)")


# ── phase 5 ──────────────────────────────────────────────────────────────────


def phase_memory(dev):
    import jax
    import jax.numpy as jnp
    from orion_sdr_tpu.demodulate.dvb_t_frame import _receive_frame_body

    cp_len, vbits = 512, 6
    n = 68 * (2048 + cp_len)
    rx = jax.jit(_receive_frame_body, static_argnums=(1, 2, 3, 4))
    compiled = rx.lower(jax.ShapeDtypeStruct((4, n), jnp.complex64),
                        68, cp_len, 0, vbits).compile()
    ma = compiled.memory_analysis()
    log(f"[memory] fused DVB-T receive (4 x 68 symbols, 64-QAM GI 1/4): "
        f"arguments {ma.argument_size_in_bytes} B, outputs "
        f"{ma.output_size_in_bytes} B, temporaries "
        f"{ma.temp_size_in_bytes} B")
    stats = dev.memory_stats() or {}
    check("peak_bytes_in_use" in stats, "device reports no memory stats")
    log(f"[memory] peak_bytes_in_use: {stats['peak_bytes_in_use']} B")


# ── --multi: four GPUs ───────────────────────────────────────────────────────


def phase_multi(devs):
    from jax.sharding import Mesh
    from orion_sdr_tpu.waveform.dvb_t import (DvbTLinkParams, DvbTFrameParams,
                                              DVB_T_N_FFT, guard_cp_len_2k)
    from orion_sdr_tpu.waveform.dvb_t_ts import TS_PAYLOAD_LEN
    from orion_sdr_tpu.modulate.dvb_t_frame import DvbTFrameMod
    from orion_sdr_tpu.demodulate.dvb_t_frame import (DvbTFrameDemod,
                                                      _receive_frame)
    from orion_sdr_tpu.parallel.sharding import dvb_t_receive_sharded
    from orion_sdr_tpu.parallel.streaming import (
        dvb_t_decode_time_sharded, viterbi_decode_sharded,
        ofdm_frame_decode_time_sharded)
    from orion_sdr_tpu.fec.conv import (viterbi_decode_soft_chunked,
                                        conv_encode_punctured)

    mesh = Mesh(np.array(devs[:4]), ("t",))
    rng = np.random.default_rng(6)

    params = DvbTFrameParams(DvbTLinkParams("1/8", "qpsk", "1/2"), 0, 0x2A)
    per_frame = _packets_per_frame(params) * TS_PAYLOAD_LEN
    frames, payloads = [], []
    for f in range(4):
        payloads.append(rng.integers(0, 256, per_frame).astype(np.uint8))
        frames.append(DvbTFrameMod(params).modulate(payloads[-1]).iq)
    cp_len = guard_cp_len_2k("1/8")
    segs = awgn(rng, np.stack(frames), 8.0)
    one = _receive_frame(segs, 68, cp_len, 0, 2)
    shard = dvb_t_receive_sharded(segs, 68, cp_len, 0, 2, mesh)
    # one program per device batch rounds the float32 FFT/equalizer sums
    # differently from the 4-frame program: compare within the tolerances
    # of tests/test_parallel.py
    d_llr = float(np.max(np.abs(one[0] - shard[0])))
    d_cell = float(np.max(np.abs(one[1] - shard[1])))
    check(d_llr <= 1e-3 and d_cell <= 1e-4,
          f"dvb_t_receive_sharded differs from one device: LLRs by "
          f"{d_llr}, TPS cells by {d_cell}")
    log(f"[multi] dvb_t_receive_sharded: 4 frames over 4 GPUs; max |diff| "
        f"to one device: LLRs {d_llr:.2e} (tolerance 1e-3), TPS cells "
        f"{d_cell:.2e} (1e-4)")

    cap = np.concatenate([np.zeros(777, np.complex64), frames[0],
                          np.zeros(2 * (DVB_T_N_FFT + cp_len), np.complex64)])
    cap = awgn(rng, cap, 8.0)
    a = DvbTFrameDemod(params).decode(cap, 68, per_frame)
    b = dvb_t_decode_time_sharded(cap, 68, per_frame, params, mesh)
    check(np.array_equal(a.payload, payloads[0]) and
          np.array_equal(b.payload, a.payload) and a.tps == b.tps,
          "dvb_t_decode_time_sharded differs from the single-device decode")
    log("[multi] dvb_t_decode_time_sharded: TS packets equal to one device")

    n_info = 400_000
    info = rng.integers(0, 2, n_info).astype(np.uint8)
    coded = np.asarray(conv_encode_punctured(info, "2/3", "dvb_k7"))
    llr = (np.where(coded == 0, 1.0, -1.0)
           + rng.standard_normal(coded.shape) * 0.6).astype(np.float32)
    a = np.asarray(viterbi_decode_soft_chunked(llr, n_info, "2/3", "dvb_k7"))
    b = viterbi_decode_sharded(llr, n_info, mesh, "2/3", "dvb_k7")
    check(np.array_equal(a, b), "viterbi_decode_sharded differs")
    log(f"[multi] viterbi_decode_sharded: {n_info} bits equal to one device "
        f"({int(np.sum(a != info))} channel errors left)")

    from orion_sdr_tpu.multicarrier import CarrierPlan
    from orion_sdr_tpu.ofdm import OfdmConfig
    from orion_sdr_tpu.sync.ofdm_sync import OfdmPreamble
    from orion_sdr_tpu.frame import (FramePacket, FrameMetadata, McsTable,
                                     OfdmFrameMod, OfdmFrameStreamDemod)
    plan = CarrierPlan(256, 64).with_contiguous_data(edge_guard=16)
    pre = OfdmPreamble(repeat_len=128, num_repeats=4).with_training_symbol(
        plan.n_fft, plan.cp_len)
    cfg = OfdmConfig(plan, fs=1e6)
    table = McsTable.default_ladder()
    data = rng.integers(0, 256, 3000).astype(np.uint8)
    iq = OfdmFrameMod(cfg, table, pre).modulate_frame(
        FramePacket(FrameMetadata(9, 1), data), 0xBEEF)
    cap = awgn(rng, np.concatenate([np.zeros(3000, np.complex64), iq,
                                    np.zeros(3000, np.complex64)]), 15.0)
    st = OfdmFrameStreamDemod(cfg, table, pre)
    ref = [r.packet for r in st.feed(cap) + st.flush() if hasattr(r, "packet")]
    got = ofdm_frame_decode_time_sharded(cfg, table, pre, cap, mesh)
    check(len(ref) == 1 and np.array_equal(ref[0].payload, data) and
          np.array_equal(got.payload, data) and
          got.metadata == ref[0].metadata,
          "ofdm_frame_decode_time_sharded differs from the stream decode")
    log("[multi] ofdm_frame_decode_time_sharded: payload and metadata equal "
        "to the single-device stream decode")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the four-GPU sharded paths")
    args = ap.parse_args(argv)
    n_devices = 4 if args.multi else 1
    devs = phase_device(n_devices)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(devs)
    else:
        for name, phase in (("parity", phase_parity), ("dvb-t", phase_dvb_t),
                            ("cofdm", phase_cofdm), ("ft8", phase_ft8)):
            t = time.perf_counter()
            phase()
            log(f"[{name}] phase done in {time.perf_counter() - t:.1f} s")
        phase_memory(devs[0])
    log(f"[done] {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)


if __name__ == "__main__":
    main()
