"""Multi-device scaling: channel-parallel and time-parallel sharding.

The reference is a single-core sample pipeline (SURVEY.md §2: no threads, no
collectives). The scaling story (BASELINE.json north star):

* channel parallel — many independent signals (FT8 windows, PSK31 candidates,
  DVB-T services) shard over the mesh's ``ch`` axis with NO communication:
  annotate the leading axis and let XLA partition the whole pipeline.
* time parallel — ONE fast stream shards its time axis into blocks; FIR
  overlap-save needs each device to see its left neighbor's last
  ``ntaps − 1`` samples. That halo crosses devices via ``ppermute`` inside a
  ``shard_map`` — exactly the reference's streaming-state carry, turned into
  a collective.
"""

from __future__ import annotations

from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P, NamedSharding

from ..dsp import fir as _fir
from ..dsp.osc import TAU


def make_mesh(n_devices: int | None = None, axis_names=("ch", "t"), shape=None):
    """A 2-D (channel × time) device mesh. Defaults to all devices on ``ch``."""
    devs = jax.devices()
    n = n_devices or len(devs)
    if shape is None:
        shape = (n, 1)
    arr = np.array(devs[:n]).reshape(shape)
    return Mesh(arr, axis_names)


def shard_channels(fn, mesh: Mesh, axis: str = "ch"):
    """Jit ``fn`` with its first argument sharded on the leading (channel)
    axis — embarrassing parallelism, no collectives."""
    sharding = NamedSharding(mesh, P(axis))

    def wrapped(x, *args, **kw):
        x = jax.device_put(x, sharding)
        return jax.jit(fn)(x, *args, **kw)

    return wrapped


def fir_overlap_save_sharded(x, taps, mesh: Mesh, time_axis: str = "t"):
    """Causal FIR over a time-sharded stream with halo exchange.

    ``x``: (..., n) with n divisible by the mesh's ``time_axis`` size. Each
    device convolves its own block after receiving the previous block's tail
    (ntaps−1 samples) from its left neighbor (`ppermute`) —
    overlap-save, bit-identical to the single-device causal FIR.
    """
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    nd = mesh.shape[time_axis]

    def block_fn(xb):
        # xb: this device's contiguous time block (leading dims intact)
        tail = xb[..., -(ntaps - 1):] if ntaps > 1 else xb[..., :0]
        left = jax.lax.ppermute(
            tail, time_axis,
            perm=[(i, (i + 1) % nd) for i in range(nd)])
        # device 0 has no left neighbor: zero its halo
        idx = jax.lax.axis_index(time_axis)
        left = jnp.where(idx == 0, jnp.zeros_like(left), left)
        y, _ = _fir.fir_apply(xb, taps, state=left)
        return y

    spec = P(*([None] * (x.ndim - 1) + [time_axis]))
    f = jax.shard_map(block_fn, mesh=mesh, in_specs=spec, out_specs=spec)
    return f(x)


def fm_demod_sharded(iq, taps, mesh: Mesh, fs: float, deviation_hz: float):
    """A demod chain sharded over BOTH axes: channels across ``ch``, the time
    axis across ``t`` with FIR + discriminator halo exchange.

    iq: (channels, n). Returns the discriminator output at the input rate.
    Demonstrates the full sharding recipe the framework scales by:
    elementwise ops partition freely; the FIR tail and the delay-conjugate
    product's previous sample are the only cross-block state, both exchanged
    via one fused ppermute.
    """
    taps = np.asarray(taps, np.float32)
    ntaps = len(taps)
    nd = mesh.shape["t"]
    k = 1.0 / max(deviation_hz, 1.0)

    def block_fn(zb):
        tail = zb[..., -ntaps:]  # FIR tail (ntaps−1) + 1 discriminator sample
        left = jax.lax.ppermute(
            tail, "t", perm=[(i, (i + 1) % nd) for i in range(nd)])
        idx = jax.lax.axis_index("t")
        left = jnp.where(idx == 0, jnp.zeros_like(left), left)
        y, _ = _fir.fir_apply(zb, taps, state=left[..., 1:])
        # previous *filtered* sample: filter the halo's last input against the
        # same state — equivalently take the filtered tail's last output. For
        # the boundary sample we recompute it from the halo (exact).
        yl, _ = _fir.fir_apply(left[..., -1:], taps, state=left[..., :-1])
        prev = jnp.concatenate([yl, y[..., :-1]], axis=-1)
        prod = y * jnp.conj(prev)
        return (jnp.arctan2(prod.imag, prod.real) * k).astype(jnp.float32)

    f = jax.shard_map(block_fn, mesh=mesh,
                      in_specs=P("ch", "t"), out_specs=P("ch", "t"))
    return f(iq)


def ofdm_soft_demap_sharded(cfg, constellation: str, iq, n_symbols: int,
                            mesh: Mesh, estimate=None):
    """Symbol-aligned time + channel sharding of the OFDM soft demap.

    OFDM receive is embarrassingly parallel once splits land on symbol
    boundaries (SURVEY §5: "symbol-aligned splits for OFDM so each device
    owns whole symbols" — no halo at all, unlike the FIR path): shard
    (channels, time) over the mesh, each device FFT-demaps its own whole
    symbols, outputs concatenate. ``iq``: (channels, n_symbols·sps).

    ``estimate``: optional held training-symbol channel estimate (n_fft,)
    complex — per-bin and shard-invariant, so it broadcasts (replicated)
    into every shard's ZF equalize; pilot_interp re-estimates per symbol
    locally instead. Matches frame.demodulator.soft_demap's equalizer
    semantics on every path.
    """
    from ..multicarrier import CarrierGrid, symbol_fft, grid_extract
    from ..constellation import soft_llr, BITS_PER_SYMBOL
    from ..ofdm import zf_equalize

    from ..ofdm import channel_estimate_pilots

    g = CarrierGrid(cfg.carrier_plan)
    sps = g.n_fft + g.cp_len
    iq = np.asarray(iq)
    ch, n = iq.shape
    assert n == n_symbols * sps
    t_dim = mesh.devices.shape[1]
    assert n_symbols % t_dim == 0, "symbols must split evenly across t"
    local_syms = n_symbols // t_dim

    def local(z, est_re, est_im):
        freq = symbol_fft(z, g.n_fft, g.cp_len,
                          backoff=cfg.rx_window_backoff,
                          n_symbols=local_syms)
        csi = None
        if cfg.equalizer_method == "pilot_interp" and g.pilot_bins.size:
            # per-symbol re-estimation is symbol-local: shards need no halo
            # (takes precedence over a held estimate, matching soft_demap)
            known = g.pilot_values * np.complex64(cfg.gain)
            est = channel_estimate_pilots(freq, g.pilot_bins, known,
                                          g.n_fft)
            freq = zf_equalize(freq, est)
            csi = (jnp.abs(est) ** 2).astype(jnp.float32)
        elif estimate is not None:
            # held per-bin estimate: identical on every shard, no halo
            est = est_re + 1j * est_im
            freq = zf_equalize(freq, est)
            csi = jnp.broadcast_to((jnp.abs(est) ** 2).astype(jnp.float32),
                                   freq.shape)
        syms = grid_extract(g, freq)
        if cfg.transform_precoding:
            # DFT-s-OFDM despread is symbol-local (per-symbol IDFT along
            # the data axis) — no halo; CSI weighting is inapplicable once
            # the IDFT mixes all bins (matches frame.demodulator.soft_demap)
            from ..ofdm import dft_deprecode
            syms = dft_deprecode(syms)
            csi = None
        if cfg.phase_tracking == "cpe":
            # the V&V raw phases are symbol-local, but the cumulative
            # unwrap runs along the WHOLE symbol axis: all-gather the
            # per-symbol scalars over 't' (n_sym floats — trivial), unwrap
            # the full run identically on every shard, slice back local.
            from ..ofdm import cpe_raw_phases, cpe_unwrap
            raw = cpe_raw_phases(syms, constellation)      # (ch_l, t_l)
            full = jax.lax.all_gather(raw, "t", axis=-1, tiled=True)
            un = cpe_unwrap(full, constellation)
            i = jax.lax.axis_index("t")
            loc = jax.lax.dynamic_slice_in_dim(
                un, i * local_syms, local_syms, axis=-1)
            rot = jnp.exp(-1j * loc.astype(jnp.float32)).astype(jnp.complex64)
            syms = syms * rot[..., None]
        flat = syms.reshape(syms.shape[:-2] + (-1,))
        llr = soft_llr(flat, constellation)
        if csi is not None:
            # CSI weighting, per-symbol normalized — identical math to
            # frame.demodulator.soft_demap, shard-invariant by construction
            cd = grid_extract(g, csi)
            w = cd / jnp.maximum(jnp.mean(cd, axis=-1, keepdims=True), 1e-9)
            wflat = w.reshape(w.shape[:-2] + (-1,))
            bits = BITS_PER_SYMBOL[constellation]
            llr = (llr.reshape(wflat.shape + (bits,)) * wflat[..., None]
                   ).reshape(llr.shape)
        return llr

    shard_fn = jax.shard_map(local, mesh=mesh,
                             in_specs=(P("ch", "t"), P(), P()),
                             out_specs=P("ch", "t"), check_vma=False)
    sh = NamedSharding(mesh, P("ch", "t"))
    # the capture goes to the devices as a (re, im) float32 pair
    re = jax.device_put(iq.real.astype(np.float32), sh)
    im = jax.device_put(iq.imag.astype(np.float32), sh)
    if estimate is not None:
        est = np.asarray(estimate)
        er = np.ascontiguousarray(est.real, np.float32)
        ei = np.ascontiguousarray(est.imag, np.float32)
    else:
        er = ei = np.zeros(g.n_fft, np.float32)
    out = jax.jit(lambda r, i, a, b: shard_fn(r + 1j * i, a, b))(
        re, im, jnp.asarray(er), jnp.asarray(ei))
    return np.asarray(out)


def dvb_t_receive_sharded(segs, n_symbols: int, cp_len: int, backoff: int,
                          vbits: int, mesh: Mesh):
    """Service-parallel DVB-T receive: B ALIGNED frame captures sharded over
    the mesh's 'ch' axis, each device running the whole fused receive
    program (symbol FFT → scattered-pilot equalize → extract → Figure-9a
    LLRs + TPS cells) on its local frames. Embarrassingly parallel — the
    multi-service monitoring workload (SURVEY §5's channel-parallel axis).

    Returns (llrs, tps_cells) as numpy, matching
    demodulate.dvb_t_frame._receive_frame.
    """
    from ..demodulate.dvb_t_frame import _receive_frame

    segs = np.asarray(segs)
    assert segs.ndim == 2
    n_dev = mesh.devices.size
    b = segs.shape[0]
    assert b % n_dev == 0, "frame count must split evenly across the mesh"

    flat_mesh = Mesh(mesh.devices.reshape(-1), ("ch",))

    def local(z):
        llrs, cells = _receive_frame(z, n_symbols, cp_len, backoff, vbits)
        # the TPS cells leave the devices as a (re, im) pair
        return llrs, cells.real.astype(jnp.float32), \
            cells.imag.astype(jnp.float32)

    shard_fn = jax.shard_map(local, mesh=flat_mesh,
                             in_specs=P("ch"),
                             out_specs=(P("ch"), P("ch"), P("ch")))
    sh = NamedSharding(flat_mesh, P("ch", None))
    re = jax.device_put(segs.real.astype(np.float32), sh)
    im = jax.device_put(segs.imag.astype(np.float32), sh)
    llrs, cr, ci = jax.jit(lambda r, i: shard_fn(r + 1j * i))(re, im)
    return np.asarray(llrs), np.asarray(cr) + 1j * np.asarray(ci)
