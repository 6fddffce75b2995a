"""Time-sharding for STREAMING receiver state (SURVEY §5).

The reference's streaming receivers carry four kinds of sequential state
across block boundaries; this module turns each into a sharded form over a
device mesh:

* **filter tails** — already in sharding.py (`fir_overlap_save_sharded`).
* **NCO/AFC/PLL phase** (ref demodulate/psk31.rs:83-409) —
  `psk31_demod_sharded`: the heavy matched-filter matmul shards over time
  blocks; the per-symbol dots (one complex value per symbol — tiny) are
  `all_gather`ed and the light decision-feedback/PLL recurrence runs
  replicated. Output is EXACTLY the single-device demod (same per-symbol
  math, same scan).
* **Viterbi trellis state** (ref codec/psk31.rs:257, fec/conv.rs) —
  `viterbi_decode_sharded`: each device owns a contiguous run of trellis
  chunks; the convergence margins (the trellis state a chunk needs from its
  neighbors) arrive as LLR halos via `ppermute`, then each device runs the
  overlap-chunked ACS locally. Output equals the single-device chunked
  decode exactly.
* **Forney interleaver lines** (ref fec/interleaver.rs:137-305) —
  `forney_deinterleave_sharded`: the delay-line history is a fixed-width
  halo (the max per-byte delay D = (I−1)·M·I) exchanged via `ppermute`;
  each device gathers its outputs from halo+block. Bit-exact.

`dvb_t_decode_time_sharded` composes these into the capstone: ONE long
conformant DVB-T capture decoded across the mesh — symbol-aligned receive
shards, sharded Viterbi, sharded Forney lines, batched native RS — equal to
the single-device `DvbTFrameDemod.decode`.
"""

from __future__ import annotations

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding


def _flat_mesh(mesh: Mesh, axis: str = "t") -> Mesh:
    """All of ``mesh``'s devices on one named time axis."""
    return Mesh(mesh.devices.reshape(-1), (axis,))


def _put_complex(mesh: Mesh, spec: P, z: np.ndarray):
    """device_put as a (re, im) float32 pair; the sharded programs rejoin
    them into complex64 on the device."""
    sh = NamedSharding(mesh, spec)
    re = jax.device_put(np.ascontiguousarray(z.real, np.float32), sh)
    im = jax.device_put(np.ascontiguousarray(z.imag, np.float32), sh)
    return re, im


# ── AFC/PLL phase: PSK31 decision-feedback demod ─────────────────────────────


def psk31_demod_sharded(iq, mesh: Mesh, fs: float, rf_hz: float = 0.0,
                        gain: float = 1.0, qpsk: bool = False):
    """Time-sharded PSK31 decision-feedback demod.

    The matched-filter dot products ⟨h, s_k⟩ (the matmul work, ~sps FLOPs per
    symbol) compute on each device's own time block; the per-symbol products
    are all-gathered (4 B/symbol — negligible traffic) and the
    decision-feedback + AFC/PLL recurrence (~10 FLOPs per symbol) runs
    replicated, carrying the exact sequential state the reference threads
    through its per-sample loop. Returns the same soft outputs as
    ``bpsk31_demod``/``qpsk31_demod``.
    """
    from ..modulate.psk31 import psk31_sps, psk31_hann
    from ..demodulate.psk31 import _pll_scan
    from ..dsp.osc import rotate_host

    sps = psk31_sps(fs)
    z = np.asarray(iq)
    if rf_hz != 0.0:
        z, _ = rotate_host(z, np.float32(-rf_hz), fs)
    fm = _flat_mesh(mesh)
    nd = fm.devices.size
    true_syms = z.shape[-1] // sps
    if true_syms == 0:
        shape = (0, 2) if qpsk else (0,)
        return np.zeros(shape, np.float32)
    # pad the symbol count to a whole number per device with zero samples;
    # the PLL scan is causal, so the real symbols' outputs are unchanged
    # and the padded tail is trimmed below
    n_syms = -(-true_syms // nd) * nd
    seg = np.zeros((n_syms, sps), z.dtype)
    seg[:true_syms] = z[: true_syms * sps].reshape(true_syms, sps)
    h = psk31_hann(sps).astype(np.float32)

    def local(re, im):
        dots_local = (re + 1j * im) @ h          # (n_syms/nd,)
        dots = jax.lax.all_gather(dots_local, "t", axis=0, tiled=True)
        soft, _ = _pll_scan(dots, sps, gain, qpsk)
        return soft.real.astype(jnp.float32) if not qpsk \
            else soft.astype(jnp.float32)

    out_spec = P(None, None) if qpsk else P(None)
    f = jax.jit(jax.shard_map(local, mesh=fm,
                              in_specs=(P("t", None), P("t", None)),
                              out_specs=out_spec, check_vma=False))
    re, im = _put_complex(fm, P("t", None), seg)
    return np.asarray(f(re, im))[:true_syms]


def psk31_stream_decode_sharded(iq, mesh: Mesh, fs: float,
                                carrier_hz: float = 0.0,
                                qpsk: bool = False) -> str:
    """End-to-end time-sharded PSK31 text decode of one long capture:
    sharded demod (above) → threshold/Viterbi decide → varicode (host).
    Matches the single-device ``Psk31Stream`` decode of the same capture."""
    from ..codec.varicode import VaricodeDecoder
    from ..codec.psk31 import viterbi_decode as psk31_viterbi_decode
    from ..demodulate.psk31 import bpsk31_decide

    soft = psk31_demod_sharded(iq, mesh, fs, rf_hz=carrier_hz, qpsk=qpsk)
    if qpsk:
        bits = np.asarray(psk31_viterbi_decode(np.asarray(soft)))
    else:
        bits = bpsk31_decide(soft)
    return VaricodeDecoder().push_bits(bits)


# ── Viterbi trellis state: chunked decode with LLR halo exchange ─────────────


def viterbi_decode_sharded(coded_llrs, info_bits: int, mesh: Mesh,
                           rate: str = "1/2", code: str = "dvb_k7"):
    """Time-sharded overlap-chunked soft Viterbi.

    Each device owns ``nchunk/nd`` contiguous trellis chunks. The trellis
    state a chunk needs from outside its block is carried by the convergence
    margins (fixed-lag property, margin ≫ 5K); those margins are LLR halos
    exchanged with both neighbors via ``ppermute`` — the collective form of
    the reference's sequential trellis carry. Decode math per chunk is
    identical to ``viterbi_decode_soft_chunked``, so outputs match it
    exactly.
    """
    from ..fec.conv import (_tables, depuncture_llrs, tail_bits,
                            viterbi_trellis, chunk_lanes, chunk_start_metrics,
                            _CHUNK_STEPS as C, _CHUNK_OVERLAP as V)

    S = _tables(code)[1]
    llrs = np.asarray(coded_llrs, np.float32)
    assert llrs.ndim == 1, "sharded path takes one long stream"
    full = np.asarray(depuncture_llrs(llrs, info_bits, rate, code))
    n_steps = info_bits + tail_bits(code)
    l0 = full[0::2]
    l1 = full[1::2]

    fm = _flat_mesh(mesh)
    nd = fm.devices.size
    nchunk = -(-n_steps // C)
    nchunk = -(-nchunk // nd) * nd          # pad to a whole number per device
    total = C * nchunk
    l0p = np.pad(l0, (0, total - n_steps))
    l1p = np.pad(l1, (0, total - n_steps))
    k = nchunk // nd                         # chunks per device

    def local(b0, b1):
        # halo exchange: V steps from the left and right neighbors
        idx = jax.lax.axis_index("t")
        right_tail0 = jax.lax.ppermute(
            b0[-V:], "t", perm=[(i, (i + 1) % nd) for i in range(nd)])
        right_tail1 = jax.lax.ppermute(
            b1[-V:], "t", perm=[(i, (i + 1) % nd) for i in range(nd)])
        left_head0 = jax.lax.ppermute(
            b0[:V], "t", perm=[(i, (i - 1) % nd) for i in range(nd)])
        left_head1 = jax.lax.ppermute(
            b1[:V], "t", perm=[(i, (i - 1) % nd) for i in range(nd)])
        zeros = jnp.zeros((V,), jnp.float32)
        lh0 = jnp.where(idx == 0, zeros, right_tail0)
        lh1 = jnp.where(idx == 0, zeros, right_tail1)
        rh0 = jnp.where(idx == nd - 1, zeros, left_head0)
        rh1 = jnp.where(idx == nd - 1, zeros, left_head1)
        c0, c1 = chunk_lanes(jnp.concatenate([lh0, b0, rh0]),
                             jnp.concatenate([lh1, b1, rh1]), k)
        # chunk 0 of device 0 pins state 0; all others start uniform
        pm0 = chunk_start_metrics(S, k, idx == 0)
        bits = viterbi_trellis(c0, c1, pm0, code, terminated=False)
        return bits[:, V:V + C].reshape(-1)

    f = jax.jit(jax.shard_map(local, mesh=fm, in_specs=(P("t"), P("t")),
                              out_specs=P("t"), check_vma=False))
    sh = NamedSharding(fm, P("t"))
    out = f(jax.device_put(l0p, sh), jax.device_put(l1p, sh))
    return np.asarray(out)[:info_bits]


# ── Forney interleaver lines: delay-line halo ────────────────────────────────


def forney_deinterleave_sharded(x, mesh: Mesh, branches: int = 12,
                                depth: int = 17):
    """Time-sharded Forney deinterleave of one long byte stream.

    The deinterleaver is a pure delayed gather: output[t] reads input
    [t − (I−1−j)·M·I] with j = t mod I — so a device needs only the last
    D = (I−1)·M·I bytes of its left neighbor (the interleaver "lines"),
    exchanged via ``ppermute``. Bit-exact vs ``forney_deinterleave``."""
    I, M = branches, depth
    D = (I - 1) * M * I
    x = np.asarray(x)
    n = x.shape[-1]
    # each block must cover the max delay; short streams use fewer devices,
    # and one shorter than the delay itself takes the plain host path
    if n < D:
        from ..fec.interleave import forney_deinterleave
        out, _ = forney_deinterleave(x, branches, depth)
        return np.asarray(out)
    all_devs = mesh.devices.reshape(-1)
    nd = int(max(1, min(all_devs.size, n // D)))
    fm = Mesh(all_devs[:nd], ("t",))
    pad = (-n) % nd          # zero-pad the tail: gathers only read backward
    if pad:
        x = np.concatenate([x, np.zeros(pad, x.dtype)])
    blk = (n + pad) // nd
    assert blk >= D, f"block ({blk}) must cover the max delay ({D})"

    def local(xb):
        idx = jax.lax.axis_index("t")
        halo = jax.lax.ppermute(
            xb[-D:], "t", perm=[(i, (i + 1) % nd) for i in range(nd)])
        halo = jnp.where(idx == 0, jnp.zeros_like(halo), halo)
        xp = jnp.concatenate([halo, xb])
        t_local = jnp.arange(blk)
        t_global = idx * blk + t_local
        j = t_global % I
        delay = (I - 1 - j) * M * I
        src = D + t_local - delay
        return xp[src]

    f = jax.jit(jax.shard_map(local, mesh=fm, in_specs=P("t"),
                              out_specs=P("t"), check_vma=False))
    sh = NamedSharding(fm, P("t"))
    return np.asarray(f(jax.device_put(x, sh)))[:n]


# ── Capstone: whole DVB-T decode, time-sharded ───────────────────────────────


def dvb_t_receive_time_sharded(iq_aligned, n_symbols: int, cp_len: int,
                               backoff: int, vbits: int, mesh: Mesh):
    """The fused DVB-T receive program over ONE long aligned capture,
    symbol-aligned time shards (SURVEY §5: each device owns whole symbols).
    Each device's symbol count must be a multiple of the 4 scattered-pilot
    phases so every shard starts at phase 0. Returns (llrs, tps_cells)
    matching ``demodulate.dvb_t_frame._receive_frame`` on the whole capture.
    """
    from ..waveform.dvb_t import DVB_T_N_FFT
    from ..demodulate.dvb_t_frame import _receive_frame

    fm = _flat_mesh(mesh)
    nd = fm.devices.size
    sps = DVB_T_N_FFT + cp_len
    # pad the symbol run so every device gets the same whole number of
    # symbols AND each shard starts at scattered phase 0 (multiple of 4);
    # the zero-padded tail symbols' outputs are trimmed below.
    quantum = 4 * nd
    n_pad_syms = -(-n_symbols // quantum) * quantum
    local_syms = n_pad_syms // nd
    iq = np.asarray(iq_aligned)[: n_symbols * sps]
    iq = np.concatenate([iq, np.zeros(n_pad_syms * sps - len(iq),
                                      np.complex64)])

    def local(re, im):
        llrs, cells = _receive_frame(re + 1j * im, local_syms, cp_len,
                                     backoff, vbits)
        # the TPS cells leave the device as a (re, im) pair, rejoined on
        # the host
        return llrs, cells.real.astype(jnp.float32), \
            cells.imag.astype(jnp.float32)

    f = jax.jit(jax.shard_map(local, mesh=fm, in_specs=(P("t"), P("t")),
                              out_specs=(P("t"), P("t"), P("t")),
                              check_vma=False))
    re, im = _put_complex(fm, P("t"), iq)
    llrs, cr, ci = f(re, im)
    cells = np.asarray(cr) + 1j * np.asarray(ci)
    return (np.asarray(llrs)[:n_symbols], cells[:n_symbols])


def dvb_t_decode_time_sharded(iq, n_symbols: int, payload_len: int, params,
                              mesh: Mesh, rx_window_backoff: int = 0):
    """Whole conformant DVB-T frame-run decode across the mesh: GI-acquire
    (host) → symbol-sharded fused receive → TPS → sharded Viterbi (LLR
    halos) → sharded Forney lines → batched native RS → TS. Output equals
    ``DvbTFrameDemod.decode`` on one device.
    """
    from ..constellation import BITS_PER_SYMBOL
    from ..waveform.dvb_t import (DVB_T_N_FFT, guard_cp_len_2k,
                                  dvb_t_frame_outer, dvb_t_frame_outer_il)
    from ..waveform.dvb_t_tps import tps_decode_frame, TpsWord, \
        TPS_SYMBOLS_PER_FRAME
    from ..waveform.dvb_t_ts import (TS_PACKET_LEN, TS_PAYLOAD_LEN,
                                     ts_energy_disperse, ts_depacketize)
    from ..sync.dvb_t_gi_sync import dvb_t_gi_sync
    from ..demodulate.dvb_t_frame import DvbTRxError, DvbTRxFrame
    from ..frame.chain import block_plan, outer_decode
    from ..frame.types import InterleaverKind
    from ..fec.interleave import conv_roundtrip_delay
    from ..frame.chain import bits_to_bytes
    from ..waveform.dvb_t import dvb_t_fs_for_bandwidth

    cp_len = guard_cp_len_2k(params.link.guard)
    sps = DVB_T_N_FFT + cp_len
    vbits = BITS_PER_SYMBOL[params.link.constellation]
    fs = dvb_t_fs_for_bandwidth(1_000_000.0)
    iq = np.asarray(iq)

    acq = dvb_t_gi_sync(iq, DVB_T_N_FFT, cp_len, fs, sps)
    if acq is None:
        raise DvbTRxError(DvbTRxError.ACQUISITION)
    start = acq.start_sample
    if len(iq) < start + n_symbols * sps:
        raise DvbTRxError(DvbTRxError.INCOMPLETE)

    llrs, cells = dvb_t_receive_time_sharded(
        iq[start: start + n_symbols * sps], n_symbols, cp_len,
        rx_window_backoff, vbits, mesh)
    llrs = llrs.reshape(-1)

    tps_word = None
    for blk in range(n_symbols // TPS_SYMBOLS_PER_FRAME):
        bits = tps_decode_frame(
            cells[blk * TPS_SYMBOLS_PER_FRAME:
                  (blk + 1) * TPS_SYMBOLS_PER_FRAME])
        tps_word = TpsWord.unpack(bits)
        if tps_word is not None:
            break
    if tps_word is None:
        raise DvbTRxError(DvbTRxError.TPS_DECODE)

    # FEC chain, sharded — mirrors frame.chain.decode_chain for the DVB-T
    # scheme (no CRC, RS(204,188) + Forney(12,17) outer-IL + DvbK7 inner, no
    # inner IL, no scrambler): inner Viterbi with LLR halos, Forney lines
    # halo, batched native RS.
    inner = params.inner()
    n_ts = max(-(-payload_len // TS_PAYLOAD_LEN), 1)
    ts_len = n_ts * TS_PACKET_LEN
    plan = block_plan(ts_len, "none", dvb_t_frame_outer(), inner,
                      dvb_t_frame_outer_il(), InterleaverKind.none())
    llrs = llrs[: plan.coded_bits]
    # inner decode: Viterbi over the whole run, time-sharded
    info = viterbi_decode_sharded(llrs, plan.outer_il_bits, mesh,
                                  inner.rate, inner.code)
    info = info[: plan.outer_il_bits]
    # outer (Forney, byte-domain) deinterleave with halo exchange; the
    # streaming deinterleaver's first d outputs are line-fill (dropped),
    # total - d carry the data (chain._deinterleave semantics)
    d = conv_roundtrip_delay(12, 17)
    total = len(info) // 8
    byts = np.packbits(info[: total * 8].astype(np.uint8))
    deint = forney_deinterleave_sharded(byts, mesh)[d:total]
    outer_de = np.unpackbits(deint.astype(np.uint8))[: plan.outer_coded_bits]
    framed_bits, ok = outer_decode(dvb_t_frame_outer(), outer_de)
    framed_bits = framed_bits[: plan.framed_bytes * 8]
    if not ok or len(framed_bits) < plan.framed_bytes * 8:
        raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
    ts_bytes = bits_to_bytes(framed_bits)[:ts_len]
    ts = ts_energy_disperse(ts_bytes)
    payload = ts_depacketize(ts)
    if payload is None:
        raise DvbTRxError(DvbTRxError.PAYLOAD_DECODE)
    return DvbTRxFrame(payload=payload[:payload_len], tps=tps_word)


# ── COFDM frame capstone: whole-frame decode, time-sharded ───────────────────


def ofdm_frame_decode_time_sharded(cfg, mcs_table, preamble, iq, mesh: Mesh,
                                   score_threshold: float = 0.5):
    """Whole COFDM frame decode across the mesh — the OFDM-frame analog of
    ``dvb_t_decode_time_sharded``: S&C acquire (host) → CFO derotate →
    training-symbol channel estimate → symbol-aligned SHARDED soft demap of
    header and payload → standard decode chains (batched LDPC BP / device
    outer FEC). Output equals ``OfdmFrameStreamDemod``'s packet for the
    same capture.
    """
    from ..sync.ofdm_sync import ofdm_sync
    from ..dsp.osc import rotate_host
    from ..frame.types import (OuterFec, InnerFec, InterleaverKind,
                               ScramblerKind, RxError, header_has_block,
                               SCRAMBLER_BEFORE_OUTER)
    from ..frame.chain import block_plan, decode_chain
    from ..frame.modulator import (HEADER_FIELD_BYTES, HEADER_CONSTELLATION,
                                   HEADER_LDPC, header_block_plan,
                                   symbols_for_coded_bits)
    from ..frame.types import FramePacket, FrameMetadata
    from .sharding import ofdm_soft_demap_sharded
    from ..multicarrier import symbol_fft
    from ..sync.ofdm_sync import training_symbol_freq_pattern
    from ..ofdm import zf_equalize

    if not header_has_block(cfg.header_format):
        raise RxError(RxError.MALFORMED_HEADER)

    iq = np.asarray(iq)
    sync = ofdm_sync(iq, cfg.fs, preamble, 0, len(iq))
    passing = [r for r in sync if r.score >= score_threshold]
    if not passing:
        raise RxError(RxError.PREAMBLE_TIMEOUT)
    best = max(passing, key=lambda r: r.score)
    spacing = cfg.fs / cfg.carrier_plan.n_fft
    total_cfo = best.cfo_hz + best.integer_cfo_bins * spacing
    corrected, _ = rotate_host(iq[best.start_sample:],
                               np.float32(-total_cfo), cfg.fs)
    corrected = np.asarray(corrected)
    body = corrected[preamble.total_len():]
    sps = cfg.carrier_plan.n_fft + cfg.carrier_plan.cp_len

    # training-hold estimate (applied per shard through a plain equalize —
    # the estimate is per-bin, so sharding needs no halo)
    est = None
    t = preamble.training_symbol
    if t is not None and cfg.equalizer_method != "pilot_interp":
        start = preamble.num_repeats * preamble.repeat_len
        freq = symbol_fft(corrected[start:start + t.n_fft + t.cp_len],
                          t.n_fft, t.cp_len,
                          backoff=cfg.rx_window_backoff, n_symbols=1)
        known = training_symbol_freq_pattern(t.n_fft) * cfg.gain
        est = (np.asarray(freq)[0] / known).astype(np.complex64)
        # same delay-domain denoise as OfdmFrameStreamDemod._estimate_channel
        from ..ofdm import channel_estimate_denoise
        est = channel_estimate_denoise(est, t.cp_len, cfg.rx_window_backoff)

    # one capture: put EVERY device on the time axis (1 × n mesh)
    tmesh = Mesh(mesh.devices.reshape(1, -1), ("ch", "t"))
    t_dim = int(tmesh.devices.shape[1])

    def demap(seg, constellation, n_sym):
        # pad the symbol run so it splits across the mesh's time axis;
        # the held training estimate (when present) broadcasts into every
        # shard's ZF equalize — per-bin, shard-invariant, no fallback
        n_pad = -(-n_sym // max(t_dim, 1)) * max(t_dim, 1)
        z = np.zeros((1, n_pad * sps), np.complex64)
        z[0, : n_sym * sps] = seg[: n_sym * sps]
        llr = ofdm_soft_demap_sharded(cfg, constellation, z, n_pad, tmesh,
                                      estimate=est)
        bps_sym = (cfg.carrier_plan.num_data_carriers()
                   * {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6,
                      "qam256": 8}[constellation])
        return np.asarray(llr).reshape(-1)[: n_sym * bps_sym]

    hplan = header_block_plan(cfg)
    n_sym_h = symbols_for_coded_bits(cfg, HEADER_CONSTELLATION,
                                     hplan.coded_bits)
    if len(body) < n_sym_h * sps:
        raise RxError(RxError.MALFORMED_HEADER)
    hllr = demap(body, HEADER_CONSTELLATION, n_sym_h)
    fields, ok = decode_chain(
        hllr, hplan, cfg.header_crc, OuterFec.none(),
        InnerFec.ldpc(HEADER_LDPC), InterleaverKind.none(),
        InterleaverKind.none(), ScramblerKind.none(),
        SCRAMBLER_BEFORE_OUTER, 0, ldpc_rule="sum_product")
    if not ok or len(fields) < HEADER_FIELD_BYTES:
        raise RxError(RxError.HEADER_CRC_MISMATCH)
    mcs_index = int(fields[0])
    payload_len = int.from_bytes(bytes(fields[1:5]), "big")
    sequence_num = int.from_bytes(bytes(fields[5:9]), "big")
    flags = int(fields[9])
    seed = int.from_bytes(bytes(fields[10:14]), "big")

    mcs = mcs_table.get(mcs_index)
    if mcs is None:
        raise RxError(RxError.MALFORMED_HEADER)
    pplan = block_plan(payload_len, cfg.payload_crc, mcs.outer_fec,
                       mcs.inner_fec, cfg.outer_interleaver,
                       cfg.inner_interleaver)
    n_sym_p = symbols_for_coded_bits(cfg, mcs.constellation,
                                     pplan.coded_bits)
    if len(body) < (n_sym_h + n_sym_p) * sps:
        raise RxError(RxError.CRC_MISMATCH)
    pllr = demap(body[n_sym_h * sps:], mcs.constellation, n_sym_p)
    data, ok = decode_chain(
        pllr, pplan, cfg.payload_crc, mcs.outer_fec, mcs.inner_fec,
        cfg.outer_interleaver, cfg.inner_interleaver, cfg.scrambler,
        cfg.scrambler_pos, seed, ldpc_rule=cfg.ldpc_decode_rule)
    if not ok:
        raise RxError(RxError.CRC_MISMATCH)
    meta = FrameMetadata(sequence_num=sequence_num, mcs_index=mcs_index,
                         flags=flags)
    return FramePacket(meta, data[:payload_len])
