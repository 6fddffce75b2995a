"""The Hopper Viterbi kernel's design and wrapper, and LDPC belief
propagation.

The CUDA kernel (ops/viterbi_cuda.cu) has no CPU form. Here it is checked
through ``_warp_model``, a NumPy model of the kernel thread for thread
(predecessor shuffles, branch signs, ballot-packed decisions, traceback),
against the plain scan; the Python around the call (dispatch rule,
reshapes, start metrics) runs with the call replaced by that model. The
kernel itself is compared with the scan on the GPU by ``chip_smoke.py`` and
by the ``gpu``-marked test below. LDPC BP's gather form is checked against
the one-hot reference in ``tools/bp_onehot.py``."""

import os
import sys

import numpy as np
import pytest
import jax
import jax.numpy as jnp

from orion_sdr_tpu.fec.conv import (CONV_CODES, conv_encode_punctured,
                                    depuncture_llrs, tail_bits, _tables,
                                    _trellis_scan, viterbi_decode_soft,
                                    viterbi_decode_soft_chunked,
                                    chunk_lanes, chunk_start_metrics,
                                    _CHUNK_STEPS, _CHUNK_OVERLAP)
from orion_sdr_tpu.ops import viterbi as ov

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
from tools.bp_onehot import bp_decode_onehot  # noqa: E402


def _parity(x):
    return np.vectorize(lambda v: bin(int(v)).count("1") & 1)(x)


def _warp_model(l0, l1, pm0, K, g0, g1, terminated):
    """viterbi_cuda.cu in NumPy: 32 lanes, lane j holding states j and
    j + H (H = 2^(K-2)); lanes >= H mirror lane j & (H-1)."""
    l0 = np.asarray(l0, np.float32)
    l1 = np.asarray(l1, np.float32)
    pm0 = np.asarray(pm0, np.float32)
    L, T = l0.shape
    top = K - 2
    H = 1 << top
    lane = np.arange(32)
    j = lane & (H - 1)
    s0 = np.zeros((2, 2, 32), np.float32)
    s1 = np.zeros((2, 2, 32), np.float32)
    for b in range(2):
        for z in range(2):
            w = (b << (K - 1)) | (j << 1) | z
            s0[b, z] = 1 - 2 * _parity(w & g0)
            s1[b, z] = 1 - 2 * _parity(w & g1)
    src = (2 * j) & (H - 1)
    from_hi = 2 * j >= H
    out = np.zeros((L, T), np.uint8)
    for r in range(L):
        lo, hi = pm0[r, j], pm0[r, j + H]
        dec = np.zeros((T, 2), np.int64)
        for t in range(T):
            la, lb = l0[r, t], l1[r, t]
            pe = np.where(from_hi, hi[src], lo[src])
            po = np.where(from_hi, hi[src + 1], lo[src + 1])
            a0 = (pe + s0[0, 0] * la) + s1[0, 0] * lb
            a1 = (po + s0[0, 1] * la) + s1[0, 1] * lb
            b0 = (pe + s0[1, 0] * la) + s1[1, 0] * lb
            b1 = (po + s0[1, 1] * la) + s1[1, 1] * lb
            d_lo, d_hi = a1 > a0, b1 > b0
            lo = np.where(d_lo, a1, a0).astype(np.float32)
            hi = np.where(d_hi, b1, b0).astype(np.float32)
            # ballots: bit i of each word is lane i's decision
            dec[t] = (int(np.sum(d_lo.astype(np.int64) << lane)),
                      int(np.sum(d_hi.astype(np.int64) << lane)))
            if not terminated:
                m = np.float32(max(lo.max(), hi.max()))
                lo, hi = lo - m, hi - m
        state = 0
        if not terminated:
            v = np.where(hi > lo, hi, lo)
            idx = np.where(hi > lo, j + H, j)
            state = int(idx[v == v.max()].min())
        for t in range(T - 1, -1, -1):
            out[r, t] = (state >> top) & 1
            word = dec[t, 1] if state >= H else dec[t, 0]
            z = (int(word) >> (state & (H - 1))) & 1
            state = ((state & (H - 1)) << 1) | z
    return out


def _start_metrics(rng, L, S, terminated):
    if terminated:
        pm0 = np.full((L, S), -1e30, np.float32)
        pm0[:, 0] = 0.0
        return pm0
    return rng.standard_normal((L, S)).astype(np.float32)


@pytest.mark.parametrize("code", ["dvb_k7", "k5"])
@pytest.mark.parametrize("terminated", [True, False])
@pytest.mark.parametrize("llrs", ["integer", "gaussian"])
def test_warp_model_matches_scan(code, terminated, llrs):
    """The kernel's layout and arithmetic reproduce the scan bit for bit,
    ties included (integer LLRs tie often)."""
    rng = np.random.default_rng(len(code) * 4 + 2 * terminated + len(llrs))
    c = CONV_CODES[code]
    S = _tables(code)[1]
    L, T = 3, 120
    if llrs == "integer":
        l0 = rng.integers(-2, 3, (L, T)).astype(np.float32)
        l1 = rng.integers(-2, 3, (L, T)).astype(np.float32)
    else:
        l0 = (rng.standard_normal((L, T)) * 3).astype(np.float32)
        l1 = (rng.standard_normal((L, T)) * 3).astype(np.float32)
    pm0 = _start_metrics(rng, L, S, terminated)
    ref = np.asarray(_trellis_scan(l0, l1, pm0, code, terminated))
    got = _warp_model(l0, l1, pm0, c["K"], c["g0"], c["g1"], terminated)
    assert np.array_equal(got, ref)


def test_trellis_impl_shape_rule(monkeypatch):
    """GPU: the kernel for every trellis that fits one block's shared memory
    (8 bytes of decisions per step) and K <= 7; the scan otherwise and on
    every other backend."""
    assert ov.trellis_impl(1216, 7) == "scan"            # CPU in tests
    assert ov.trellis_impl(1, 5) == "scan"
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert ov.trellis_impl(1216, 7) == "cuda"
    assert ov.trellis_impl(1, 5) == "cuda"
    assert ov.trellis_impl(ov.MAX_KERNEL_STEPS, 7) == "cuda"
    assert ov.trellis_impl(ov.MAX_KERNEL_STEPS + 1, 7) == "scan"
    assert ov.trellis_impl(0, 7) == "scan"
    assert ov.trellis_impl(100, 9) == "scan"
    assert ov.MAX_KERNEL_STEPS * 8 <= 232448


@pytest.fixture
def model_kernel(monkeypatch):
    """Routes viterbi_trellis through trellis_cuda's Python with the FFI
    call replaced by the NumPy warp model; returns the (L, T) shapes the
    kernel was handed."""
    calls = []

    def fake_call(l0, l1, pm0, K, g0, g1, terminated):
        calls.append(tuple(l0.shape))
        return jax.pure_callback(
            lambda a, b, p: _warp_model(a, b, p, K, g0, g1, terminated),
            jax.ShapeDtypeStruct(l0.shape, jnp.uint8), l0, l1, pm0)

    monkeypatch.setattr(ov, "trellis_impl",
                        lambda n_steps, K: "cuda")
    monkeypatch.setattr(ov, "_register", lambda: None)
    monkeypatch.setattr(jax.ffi, "ffi_call",
                        lambda name, shape: (lambda l0, l1, pm0, K, g0, g1,
                                             terminated: fake_call(
                                                 l0, l1, pm0, int(K), int(g0),
                                                 int(g1), bool(terminated))))
    return calls


def _coded(code, rate, info, rng, flip):
    coded = np.stack([np.asarray(conv_encode_punctured(r, rate, code))
                      for r in info])
    llr = np.where(coded == 0, 4.0, -4.0).astype(np.float32)
    return np.where(rng.random(llr.shape) < flip, -llr, llr)


def _unterminated(impl, l0, l1, pm0, code):
    """A chunk lane (argmax-start traceback, per-step renormalisation)
    through the scan or through the kernel's NumPy model."""
    if impl == "scan":
        return np.asarray(_trellis_scan(l0, l1, pm0, code, False))
    c = CONV_CODES[code]
    return _warp_model(l0, l1, pm0, c["K"], c["g0"], c["g1"], False)


@pytest.mark.parametrize("impl", ["scan", "kernel_model"])
def test_chunk_covering_whole_trellis_matches_full(impl):
    """One chunk spanning a whole zero-tail trellis, started at state 0,
    reproduces the terminated Viterbi exactly: at termination the final
    argmax is state 0."""
    rng = np.random.default_rng(1)
    code, rate, n_info = "dvb_k7", "1/2", 120
    info = rng.integers(0, 2, (2, n_info)).astype(np.uint8)
    llr = _coded(code, rate, info, rng, 0.02)
    ref = np.asarray(viterbi_decode_soft(llr, n_info, rate, code))
    full = np.asarray(depuncture_llrs(llr, n_info, rate, code))
    pm0 = _start_metrics(rng, 2, 64, True)
    bits = _unterminated(impl, full[:, 0::2], full[:, 1::2], pm0, code)
    assert np.array_equal(bits[:, :n_info], ref)
    assert np.array_equal(bits[:, :n_info], info)


@pytest.mark.parametrize("impl", ["scan", "kernel_model"])
def test_chunk_uniform_start_converges(impl):
    """A chunk started with uniform metrics (unknown state) matches the
    full decode once past the V-step margin at either end."""
    rng = np.random.default_rng(2)
    code, rate, n_info, V = "dvb_k7", "1/2", 400, _CHUNK_OVERLAP
    info = rng.integers(0, 2, (1, n_info)).astype(np.uint8)
    llr = _coded(code, rate, info, rng, 0.02)
    ref = np.asarray(viterbi_decode_soft(llr, n_info, rate, code))[0]
    full = np.asarray(depuncture_llrs(llr, n_info, rate, code))
    pm0 = np.zeros((1, 64), np.float32)
    bits = _unterminated(impl, full[:, 0::2], full[:, 1::2], pm0, code)[0]
    n_steps = n_info + tail_bits(code)
    assert np.array_equal(bits[V:n_steps - V], ref[V:n_steps - V])


def test_chunked_decode_through_kernel_wrapper(model_kernel):
    """Two streams of three chunks each reach the kernel as six lanes of
    C + 2V steps, and decode to the scan path's bits."""
    rng = np.random.default_rng(3)
    n_info = 2 * _CHUNK_STEPS + 300
    info = rng.integers(0, 2, (2, n_info)).astype(np.uint8)
    llr = _coded("dvb_k7", "2/3", info, rng, 0.005)
    got = np.asarray(viterbi_decode_soft_chunked(llr, n_info, "2/3",
                                                 "dvb_k7"))
    assert model_kernel == [(6, _CHUNK_STEPS + 2 * _CHUNK_OVERLAP)]
    full = np.asarray(depuncture_llrs(llr, n_info, "2/3", "dvb_k7"))
    pad = ((0, 0), (_CHUNK_OVERLAP, 3 * _CHUNK_STEPS - n_info - 6
                    + _CHUNK_OVERLAP))
    c0, c1 = chunk_lanes(np.pad(full[:, 0::2], pad),
                         np.pad(full[:, 1::2], pad), 3)
    pm0 = np.broadcast_to(np.asarray(chunk_start_metrics(64, 3, True)),
                          (2, 3, 64))
    ref = np.asarray(_trellis_scan(c0, c1, pm0, "dvb_k7", False))
    ref = ref[:, :, _CHUNK_OVERLAP:_CHUNK_OVERLAP + _CHUNK_STEPS]
    assert np.array_equal(got, ref.reshape(2, -1)[:, :n_info])
    assert np.mean(got != info) < 1e-3


def test_terminated_decode_through_kernel_wrapper(model_kernel):
    """A (2, 3) batch of short K=5 codewords reaches the kernel as six
    lanes pinned at state 0, and decodes exactly like the scan path."""
    rng = np.random.default_rng(4)
    info = rng.integers(0, 2, (6, 150)).astype(np.uint8)
    llr = _coded("k5", "1/2", info, rng, 0.03).reshape(2, 3, -1)
    got = np.asarray(viterbi_decode_soft(llr, 150, "1/2", "k5"))
    assert model_kernel == [(6, 150 + tail_bits("k5"))]
    full = np.asarray(depuncture_llrs(llr, 150, "1/2", "k5"))
    pm0 = _start_metrics(rng, 6, 16, True).reshape(2, 3, 16)
    ref = np.asarray(_trellis_scan(full[..., 0::2], full[..., 1::2], pm0,
                                   "k5", True))[..., :150]
    assert got.shape == (2, 3, 150) and np.array_equal(got, ref)


def test_chunk_helpers():
    """Chunk lanes overlap by 2V and start at multiples of C; only chunk 0
    (where pinned) starts at state 0."""
    C, V = _CHUNK_STEPS, _CHUNK_OVERLAP
    x = np.arange(V + 3 * C + V, dtype=np.float32)[None]
    a, b = chunk_lanes(x, -x, 3)
    assert a.shape == (1, 3, C + 2 * V)
    assert np.array_equal(a[0, :, 0], [0, C, 2 * C])
    assert np.array_equal(b, -a)
    pm = np.asarray(chunk_start_metrics(64, 3, True))
    assert pm[0, 0] == 0.0 and (pm[0, 1:] < -1e29).all()
    assert not pm[1:].any()
    assert not np.asarray(chunk_start_metrics(64, 3, False)).any()


def test_build_needs_nvcc(monkeypatch, tmp_path):
    """Without nvcc the build says so (no silent fall back to the scan)."""
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(ov, "_BUILD", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="nvcc"):
        ov.build_library()


@pytest.mark.gpu
def test_cuda_kernel_matches_scan_on_gpu(gpu):
    rng = np.random.default_rng(5)
    for code, terminated, T in (("dvb_k7", False, 1216), ("k5", True, 300)):
        c = CONV_CODES[code]
        S = _tables(code)[1]
        l0 = (rng.standard_normal((40, T)) * 3).astype(np.float32)
        l1 = (rng.standard_normal((40, T)) * 3).astype(np.float32)
        pm0 = _start_metrics(rng, 40, S, terminated)
        got = ov.trellis_cuda(l0, l1, pm0, c["K"], c["g0"], c["g1"],
                              terminated)
        ref = _trellis_scan(l0, l1, pm0, code, terminated)
        assert np.array_equal(np.asarray(got), np.asarray(ref))


# ── LDPC belief propagation ──────────────────────────────────────────────────

def _bp_case(name, n_flips, B, seed):
    from orion_sdr_tpu.fec import ldpc_encode, ldpc_graph
    g = ldpc_graph(name)
    rng = np.random.default_rng(seed)
    msg = rng.integers(0, 2, (B, g.k)).astype(np.uint8)
    cw = np.asarray(ldpc_encode(name, msg))
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    for b in range(B):
        llr[b, rng.choice(g.n, n_flips, replace=False)] *= -1
    return g, msg, llr


def _ft8_case(n_flips, seed):
    from orion_sdr_tpu.codec.ft8_ldpc import ft8_ldpc_graph
    from orion_sdr_tpu.codec import ft8_ldpc
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 2, (2, 91)).astype(np.uint8)
    cw = np.asarray(ft8_ldpc.ldpc_encode(m))
    llr = np.where(cw == 0, 4.0, -4.0).astype(np.float32)
    llr[0, rng.choice(174, n_flips, replace=False)] *= -1
    return ft8_ldpc_graph(), m, llr


@pytest.mark.parametrize("code", ["N512R12", "FT8"])
@pytest.mark.parametrize("rule", ["sum_product", "min_sum", "scaled_min_sum"])
def test_bp_gather_form_matches_onehot(code, rule):
    """The library's gather form and the one-hot reference decode the same
    codewords with the same unsat counts, garbage rows included."""
    from orion_sdr_tpu.fec.ldpc import bp_decode, ldpc_graph, ldpc_encode
    from orion_sdr_tpu.codec.ft8_ldpc import ft8_ldpc_graph
    from orion_sdr_tpu.codec import ft8_ldpc
    rng = np.random.default_rng(17)
    g = ldpc_graph(code) if code != "FT8" else ft8_ldpc_graph()
    msg = rng.integers(0, 2, (6, g.k)).astype(np.uint8)
    cw = np.asarray(ldpc_encode(code, msg) if code != "FT8"
                    else ft8_ldpc.ldpc_encode(msg))
    llr = (np.where(cw == 0, 2.0, -2.0)
           + rng.standard_normal(cw.shape) * 0.9).astype(np.float32)
    llr[-1] = rng.standard_normal(g.n)            # undecodable row
    bits, unsat = map(np.asarray, bp_decode(g, llr, 30, rule))
    ref_bits, ref_unsat = map(np.asarray, bp_decode_onehot(g, llr, 30, rule))
    assert np.array_equal(unsat, ref_unsat)
    assert np.array_equal(bits[:-1], ref_bits[:-1])
    assert np.array_equal(bits[:-1], msg[:-1]) and unsat[-1] > 0


def test_bp_decodes_n512():
    from orion_sdr_tpu.fec.ldpc import bp_decode
    g, msg, llr = _bp_case("N512R12", 8, 3, 0)
    bits, unsat = bp_decode(g, llr, 30, "sum_product")
    assert int(np.asarray(unsat).sum()) == 0
    assert np.array_equal(np.asarray(bits), msg)


def test_bp_decodes_ft8():
    from orion_sdr_tpu.fec.ldpc import bp_decode
    g, m, llr = _ft8_case(6, 1)
    bits, unsat = bp_decode(g, llr, 20)
    assert int(np.asarray(unsat).sum()) == 0
    assert np.array_equal(np.asarray(bits), m)


def test_bp_reports_unsat_on_garbage():
    from orion_sdr_tpu.fec.ldpc import ldpc_graph, bp_decode
    g = ldpc_graph("N512R12")
    llr = np.random.default_rng(2).standard_normal((2, g.n)).astype(
        np.float32)
    _, unsat = bp_decode(g, llr, 15)
    assert (np.asarray(unsat) > 0).all()


def test_bp_edge_tables_structure():
    """Every real edge appears once in its bit's row of ``_bit_edges`` and
    points back at that bit; padding is the zero slot E; a bit's degree is
    its column weight (3 for message bits, 1 or 2 on the staircase)."""
    from orion_sdr_tpu.fec.ldpc import ldpc_graph, _graph_key, _bit_edges
    for name in ("N512R12", "N576R23"):
        g = ldpc_graph(name)
        E = g.m * g.max_deg
        table = _bit_edges(_graph_key(g))
        assert table.shape[0] == g.n
        real = table[table < E]
        assert np.array_equal(np.sort(real),
                              np.flatnonzero(g.check_mask.reshape(-1)))
        flat_bits = g.check_bits.reshape(-1)
        for b in (0, g.k - 1, g.k, g.n - 1):
            es = table[b][table[b] < E]
            assert (flat_bits[es] == b).all()
        deg = (table < E).sum(axis=1)
        assert (deg[:g.k] == 3).all() and set(deg[g.k:]) <= {1, 2}


def test_bp_min_sum_decodes():
    from orion_sdr_tpu.fec.ldpc import bp_decode
    for name, flips in (("N512R12", 8), ("N512R34", 4), ("N576R23", 6)):
        g, msg, llr = _bp_case(name, flips, 3, 7)
        bits, unsat = bp_decode(g, llr, 30, "min_sum")
        assert int(np.asarray(unsat).sum()) == 0, name
        assert np.array_equal(np.asarray(bits), msg), name


def test_bp_scaled_min_sum_decodes():
    from orion_sdr_tpu.fec.ldpc import bp_decode
    g, msg, llr = _bp_case("N512R12", 10, 4, 11)
    bits, unsat = bp_decode(g, llr, 30, "scaled_min_sum", 0.75)
    assert int(np.asarray(unsat).sum()) == 0
    assert np.array_equal(np.asarray(bits), msg)


def test_bp_min_sum_ft8_graph():
    from orion_sdr_tpu.fec.ldpc import bp_decode
    g, m, llr = _ft8_case(5, 3)
    bits, unsat = bp_decode(g, llr, 25, "min_sum")
    assert int(np.asarray(unsat).sum()) == 0
    assert np.array_equal(np.asarray(bits), m)


def test_bp_min_sum_unsat_on_garbage():
    from orion_sdr_tpu.fec.ldpc import ldpc_graph, bp_decode
    g = ldpc_graph("N512R12")
    llr = np.random.default_rng(5).standard_normal((2, g.n)).astype(
        np.float32)
    _, unsat = bp_decode(g, llr, 15, "min_sum")
    assert (np.asarray(unsat) > 0).all()


def test_check_tables_structure():
    """Check rows list their bits then pad with the dummy bit n; the mask
    marks exactly the real slots; degrees match the A block plus the
    staircase (1 parity bit on check 0, 2 elsewhere)."""
    from orion_sdr_tpu.fec.ldpc import ldpc_graph
    for name in ("N512R12", "N512R34"):
        g = ldpc_graph(name)
        assert np.array_equal(g.check_bits == g.n, ~g.check_mask)
        deg = g.check_mask.sum(axis=1)
        stair = np.full(g.m, 2)
        stair[0] = 1
        assert np.array_equal(deg, g.A.sum(axis=1) + stair)
        assert g.max_deg == deg.max()


def test_bp_max_iter_param():
    """max_iter bounds the loop without changing decodable-case results."""
    from orion_sdr_tpu.fec.ldpc import bp_decode
    g, msg, llr = _bp_case("N512R12", 6, 2, 13)
    for rule in ("sum_product", "min_sum"):
        for max_iter in (10, 50):
            bits, unsat = bp_decode(g, llr, max_iter, rule)
            assert int(np.asarray(unsat).sum()) == 0
            assert np.array_equal(np.asarray(bits), msg)
