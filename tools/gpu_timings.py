#!/usr/bin/env python3
"""Times each hand-written or alternative implementation against its plain
XLA counterpart on one GPU, at the widths the receive chains use:

* Viterbi: the CUDA kernel vs the ``lax.scan`` trellis on DVB-T chunk lanes
  (alone), and ``DvbTSuperFrameDemod.decode_batch`` end to end;
* LDPC BP: the library's gather form vs the one-hot form
  (``tools/bp_onehot.py``) alone, at the batches the chains send, every
  decode rule, with a check that both decode the same codewords;
* outer codes: device BCH/RS decoders vs the native host decoders at the
  DVB-T and COFDM frame batches;
* end to end, A B B A A B B A in one process: the two BP forms inside the COFDM
  stream and batch decoders and ``ft8_decode_windows``, and the outer-code
  gate vs native decoding inside the DVB-T 64-QAM decoders; each slot also
  reports the time spent inside BP or the outer decode.

    python tools/gpu_timings.py                  # everything, kernel path
    python tools/gpu_timings.py --viterbi scan   # DVB-T end to end, scan path
    python tools/gpu_timings.py --ab-only        # the end-to-end A/B only

Times are host-clock wall times of warm calls that end in a host copy (the
chain's own boundary), median of ``--reps``. The last line of the output is
every result as one JSON object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn, reps: int) -> float:
    """Median seconds of ``reps`` warm calls (two warm-ups first)."""
    fn()
    fn()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def viterbi_alone(reps: int) -> dict:
    import jax
    from orion_sdr_tpu.fec.conv import _trellis_scan, _CHUNK_STEPS, \
        _CHUNK_OVERLAP
    from orion_sdr_tpu.ops.viterbi import trellis_cuda

    span = _CHUNK_STEPS + 2 * _CHUNK_OVERLAP
    rng = np.random.default_rng(0)
    scan = jax.jit(_trellis_scan, static_argnums=(3, 4))
    kern = jax.jit(lambda a, b, p: trellis_cuda(a, b, p, 7, 0b1111001,
                                                0b1011011, False))
    out = {}
    for L in (101, 402, 1608):
        l0 = jax.device_put((rng.standard_normal((L, span)) * 3
                             ).astype(np.float32))
        l1 = jax.device_put((rng.standard_normal((L, span)) * 3
                             ).astype(np.float32))
        pm0 = jax.device_put(np.zeros((L, 64), np.float32))
        t_scan = timed(lambda: scan(l0, l1, pm0, "dvb_k7", False)
                       .block_until_ready(), reps)
        t_kern = timed(lambda: kern(l0, l1, pm0).block_until_ready(), reps)
        out[f"L{L}"] = {"scan_s": t_scan, "cuda_s": t_kern}
        print(f"[viterbi] L={L} x {span} steps: scan {t_scan * 1e3:.3f} ms, "
              f"kernel {t_kern * 1e3:.3f} ms ({t_scan / t_kern:.1f}x)",
              flush=True)
    return out


def dvb_t_end_to_end(reps: int) -> dict:
    from chip_smoke import DVB_T_MODES, dvb_t_capture
    from orion_sdr_tpu.demodulate.dvb_t_super_frame import DvbTSuperFrameDemod

    out = {}
    for guard, const, rate, snr in DVB_T_MODES:
        sp, sf, payload, _, _, cap = dvb_t_capture(guard, const, rate, snr)
        demod = DvbTSuperFrameDemod(sp)

        def run():
            r = demod.decode_batch(cap, sf.symbols_per_frame,
                                   sf.frame_payload_lens)
            assert np.array_equal(r.payload, payload)

        t = timed(run, reps)
        out[f"{const}_r{rate}"] = {"decode_batch_s": t}
        print(f"[dvb-t] {const} r{rate} GI {guard}: decode_batch "
              f"{t * 1e3:.1f} ms per super-frame "
              f"({t / 4 * 1e3:.1f} ms/frame)", flush=True)
    return out


# (code, batch): N512R12 x 1 and x 73 are what the COFDM stream decoder
# sends per frame (header, then the payload of a 1500-byte frame); x 1168 is
# 16 such frames through OfdmFrameDemod.decode_batch; FT8 x 64 is
# ft8_decode_windows over 4 windows of 16 candidates
BP_BATCHES = (("N512R12", 1), ("N512R12", 73), ("N512R12", 1168),
              ("N512R12", 4096), ("FT8", 64), ("FT8", 1024))
BP_RULES = ("sum_product", "min_sum", "scaled_min_sum")


def bp_times(reps: int) -> dict:
    from orion_sdr_tpu.fec.ldpc import ldpc_graph, ldpc_encode, bp_decode
    from orion_sdr_tpu.codec.ft8_ldpc import ft8_ldpc_graph
    from orion_sdr_tpu.codec import ft8_ldpc
    from tools.bp_onehot import bp_decode_onehot

    rng = np.random.default_rng(3)
    out = {}
    for name, B in BP_BATCHES:
        if name == "FT8":
            graph, encode = ft8_ldpc_graph(), ft8_ldpc.ldpc_encode
        else:
            graph = ldpc_graph(name)
            encode = lambda m: ldpc_encode("N512R12", m)
        msg = rng.integers(0, 2, (B, graph.k)).astype(np.uint8)
        cw = np.asarray(encode(msg))
        llr = (np.where(cw == 0, 2.0, -2.0)
               + rng.standard_normal(cw.shape) * 0.8).astype(np.float32)
        for rule in BP_RULES:
            bits, unsat = bp_decode(graph, llr, 50, rule, 0.75)
            rbits, runsat = bp_decode_onehot(graph, llr, 50, rule, 0.75)
            n_diff = int(np.sum(np.any(bits != rbits, axis=1)
                                | (unsat != runsat)))
            n_dec = int(np.sum(unsat == 0))
            t_g = timed(lambda: bp_decode(graph, llr, 50, rule, 0.75), reps)
            t_o = timed(lambda: bp_decode_onehot(graph, llr, 50, rule, 0.75),
                        reps)
            out[f"{name}_B{B}_{rule}"] = {"gather_s": t_g, "onehot_s": t_o,
                                          "decoded": n_dec,
                                          "differ": n_diff}
            print(f"[bp] {name} B={B} {rule}: gather {t_g * 1e3:.3f} ms, "
                  f"one-hot {t_o * 1e3:.3f} ms; {n_dec}/{B} decoded, "
                  f"{n_diff} codewords differ between the forms", flush=True)
    return out


def outer_codes(reps: int) -> dict:
    from orion_sdr_tpu import native
    from orion_sdr_tpu.fec.galois import ReedSolomon
    from orion_sdr_tpu.fec.bch_device import (rs_decode_batch_device,
                                              bch_decode_batch_device)
    from orion_sdr_tpu.frame.chain import shortened_bch_for

    rng = np.random.default_rng(4)
    out = {}
    rs = ReedSolomon(204, 16)
    for n_blk in (51, 240, 960):
        msgs = rng.integers(0, 256, (n_blk, 188)).astype(np.uint8)
        cw = np.asarray(rs.encode(msgs), np.uint8)
        for i in range(0, n_blk, 8):
            pos = rng.choice(204, 4, replace=False)
            cw[i, pos] ^= rng.integers(1, 256, 4).astype(np.uint8)
        t_dev = timed(lambda: rs_decode_batch_device(204, 16, cw), reps)
        t_nat = timed(lambda: native.rs_decode_batch(204, 16, cw), reps)
        out[f"rs204_B{n_blk}"] = {"device_s": t_dev, "native_s": t_nat}
        print(f"[outer] RS(204,188) x {n_blk}: device {t_dev * 1e3:.3f} ms, "
              f"native {t_nat * 1e3:.3f} ms", flush=True)
    bch = shortened_bch_for(8)
    for n_blk in (101, 404, 1616):
        msgs = rng.integers(0, 2, (n_blk, bch.k)).astype(np.uint8)
        cw = np.asarray(bch.encode(msgs), np.uint8)
        for i in range(0, n_blk, 8):
            cw[i, rng.choice(bch.n, 2, replace=False)] ^= 1
        t_dev = timed(lambda: bch_decode_batch_device(bch.n, bch.k, 8, cw),
                      reps)
        t_nat = timed(lambda: native.bch_decode_batch(bch.n, bch.k, 8, cw),
                      reps)
        out[f"bch8_B{n_blk}"] = {"device_s": t_dev, "native_s": t_nat}
        print(f"[outer] BCH t=8 ({bch.n},{bch.k}) x {n_blk}: device "
              f"{t_dev * 1e3:.3f} ms, native {t_nat * 1e3:.3f} ms",
              flush=True)
    return out


class _Probe:
    """Host-clock seconds spent inside the functions it wraps."""

    def __init__(self):
        self.s = 0.0

    def wrap(self, fn):
        def call(*args, **kwargs):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kwargs)
            finally:
                self.s += time.perf_counter() - t0
        return call


def _ab(label: str, use, a: str, b: str, run, reps: int, probe: _Probe,
        layer: str) -> dict:
    """Slots a b b a a b b a (``use(x)`` switches to x), each two warm-ups
    and then ``reps`` timed runs: per slot, the median run and the mean
    time per run inside ``layer`` (what ``probe`` wraps)."""
    res = {a: [], b: [], f"{a}_{layer}": [], f"{b}_{layer}": []}
    for slot in (a, b, b, a, a, b, b, a):
        use(slot)
        run()
        run()
        probe.s = 0.0
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            run()
            ts.append(time.perf_counter() - t0)
        res[slot].append(float(np.median(ts)))
        res[f"{slot}_{layer}"].append(probe.s / reps)
    use(a)
    m = {k: float(np.mean(v)) for k, v in res.items()}

    def slots(k):
        return ", ".join(f"{t * 1e3:.2f}" for t in res[k])

    print(f"[ab] {label}: {a} {m[a] * 1e3:.3f} ms ({slots(a)}), {layer} "
          f"{m[f'{a}_{layer}'] * 1e3:.3f} ms ({slots(f'{a}_{layer}')}); {b} "
          f"{m[b] * 1e3:.3f} ms ({slots(b)}), {layer} "
          f"{m[f'{b}_{layer}'] * 1e3:.3f} ms ({slots(f'{b}_{layer}')}); "
          f"{b}/{a} = {m[b] / m[a]:.4f}, {layer} {b}/{a} = "
          f"{m[f'{b}_{layer}'] / m[f'{a}_{layer}']:.4f}", flush=True)
    return res


def chains_ab(reps: int) -> dict:
    import chip_smoke as cs
    from orion_sdr_tpu.fec import ldpc
    from orion_sdr_tpu.codec import ft8_ldpc
    from orion_sdr_tpu.frame import (chain, FrameMetadata, FramePacket,
                                     OfdmFrameDemod, OfdmFrameMod)
    from orion_sdr_tpu.codec.ft8_stream import ft8_decode_windows
    from orion_sdr_tpu.demodulate.dvb_t_super_frame import DvbTSuperFrameDemod
    from tools.bp_onehot import bp_decode_onehot

    bp = _Probe()
    gather = ldpc.bp_decode
    forms = {"gather": bp.wrap(gather), "onehot": bp.wrap(bp_decode_onehot)}

    def use_bp(form):
        # both call sites look the name up at each host-side call
        ldpc.bp_decode = ft8_ldpc.bp_decode = forms[form]

    outer = _Probe()
    outer_decode = chain.outer_decode
    chain.outer_decode = outer.wrap(outer_decode)
    n_min = chain._DEVICE_OUTER_MIN_BLOCKS

    def use_outer(which):
        chain._DEVICE_OUTER_MIN_BLOCKS = n_min if which == "gate" else 1 << 62

    out = {}
    for rule in ("sum_product", "scaled_min_sum"):
        cfg, table, pre = cs.cofdm_link(rule)
        cap, sent = cs.cofdm_capture(cfg, table, pre,
                                     np.random.default_rng(4))

        def stream():
            got, res = cs.cofdm_stream(cfg, table, pre, cap)
            assert len(got) == 4 and all(
                np.array_equal(p.payload, d) for (_, d), p in zip(sent, got))

        out[f"cofdm stream {rule}"] = _ab(
            f"BP form, COFDM stream, 4 frames, {rule}", use_bp, "gather",
            "onehot", stream, reps, bp, "bp")

        rng = np.random.default_rng(8)
        mod = OfdmFrameMod(cfg, table, pre)
        frames, datas = [], []
        for i in range(16):
            datas.append(rng.integers(0, 256, 1500).astype(np.uint8))
            iq = mod.modulate_frame(FramePacket(FrameMetadata(i, 0),
                                                datas[-1]), 0x2000 + i)
            frames.append(iq[pre.total_len():])
        aligned = cs.awgn(rng, np.stack(frames), cs.COFDM_SNR_DB)
        demod = OfdmFrameDemod(cfg, table)

        def batch():
            res = demod.decode_batch(aligned)
            assert all(np.array_equal(p.payload, d)
                       for p, d in zip(res, datas))

        out[f"cofdm decode_batch {rule}"] = _ab(
            f"BP form, COFDM decode_batch, 16 frames, {rule}", use_bp,
            "gather", "onehot", batch, reps, bp, "bp")

    windows, sent8, ht = cs.ft8_windows(np.random.default_rng(5))

    def ft8():
        first = ft8_decode_windows(windows, cs.FT8_FS, 200.0, 3000.0,
                                   max_cand=16, hash_table=ht)
        assert all(r is not None and r.message.call_de in calls
                   for r, calls in zip(first, sent8))

    out["ft8_decode_windows"] = _ab("BP form, ft8_decode_windows, 4 windows",
                                    use_bp, "gather", "onehot", ft8, reps,
                                    bp, "bp")

    sp, sf, payload, n_pkt, _, cap = cs.dvb_t_capture(*cs.DVB_T_MODES[1])
    demod = DvbTSuperFrameDemod(sp)

    def dvb_batch():
        r = demod.decode_batch(cap, sf.symbols_per_frame,
                               sf.frame_payload_lens)
        assert np.array_equal(r.payload, payload)

    def dvb_stream():
        res = cs.dvb_t_stream(sp, sf, n_pkt, cap)
        assert len(res) == 4 and all(hasattr(r, "payload") for r in res)

    out["dvb-t qam64 decode_batch"] = _ab(
        f"outer codes, DVB-T 64-QAM decode_batch ({n_pkt} RS codewords per "
        f"frame)", use_outer, "gate", "native", dvb_batch, reps, outer,
        "outer")
    out["dvb-t qam64 stream"] = _ab(
        "outer codes, DVB-T 64-QAM stream", use_outer, "gate", "native",
        dvb_stream, reps, outer, "outer")
    ldpc.bp_decode = ft8_ldpc.bp_decode = gather
    chain.outer_decode = outer_decode
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--viterbi", choices=("dispatch", "scan"),
                    default="dispatch",
                    help="'scan' forces the plain trellis everywhere and "
                         "times only the end-to-end DVB-T decode")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--ab-reps", type=int, default=7,
                    help="timed runs per slot of the end-to-end A/B")
    ap.add_argument("--ab-only", action="store_true",
                    help="run only the end-to-end A/B")
    args = ap.parse_args(argv)

    import jax
    from orion_sdr_tpu.runtime import use_compile_cache
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX found {dev.platform}")
    use_compile_cache()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"[device] {smi}; jax {jax.__version__}; viterbi={args.viterbi}",
          flush=True)
    res = {"device": smi, "device_kind": dev.device_kind,
           "viterbi": args.viterbi}
    if args.ab_only:
        res["ab"] = chains_ab(args.ab_reps)
    elif args.viterbi == "scan":
        from orion_sdr_tpu.ops import viterbi
        viterbi.trellis_impl = lambda n_steps, K: "scan"
        res["dvb_t_e2e"] = dvb_t_end_to_end(args.reps)
    else:
        res["viterbi_alone"] = viterbi_alone(args.reps)
        res["bp"] = bp_times(args.reps)
        res["outer"] = outer_codes(args.reps)
        res["dvb_t_e2e"] = dvb_t_end_to_end(args.reps)
        res["ab"] = chains_ab(args.ab_reps)
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
