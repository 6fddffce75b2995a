"""Streaming multi-channel channelizer (beyond-reference).

One batched device program extracts C baseband channels from a wideband
capture: per-channel mix (a (C, N) elementwise complex rotate), one
batched anti-alias FIR (conv/overlap-save convolution shared across the
channel batch), decimate to the channel rate. Carried mixer phases and
filter tails make it chunk-boundary invariant; adding channels widens the
batch instead of adding passes. The gateway front end for the band
receivers (`OfdmFrameBandStreamDemod`, `DvbTBandStreamDemod`).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import jax.numpy as jnp

from .device import cjit, sanitize_iq
from .fir import (fir_apply, fir_filter_aligned, kaiser_lowpass_taps,
                  kaiser_num_taps)

_TAU = float(2.0 * np.pi)


@cjit
def _channelize_block(iq, centers, phase0, fir_state, taps: tuple, m: int,
                      fs: float):
    """Mix C channels to baseband + lowpass + decimate, one device program.

    ``iq`` (L,) with L a multiple of ``m``; ``centers`` (C,) Hz; ``phase0``
    (C,) carried mixer phases; ``fir_state`` (C, ntaps−1) carried filter
    tails; ``taps`` as a TUPLE (static — the FIR lowering needs concrete
    design data). Returns (y (C, L/m), phase_out (C,), new_state).
    """
    z = jnp.asarray(iq)
    f = jnp.asarray(centers, jnp.float32)
    n = z.shape[-1]
    w = jnp.float32(-_TAU / fs) * f                       # rad/sample
    k = jnp.arange(1, n + 1, dtype=jnp.float32)
    ph = jnp.asarray(phase0, jnp.float32)[:, None] + w[:, None] * k
    zb = z[None, :] * jnp.exp(1j * ph)
    phase_out = jnp.remainder(jnp.asarray(phase0, jnp.float32) + w * n,
                              jnp.float32(_TAU))
    y, st = fir_apply(zb, np.asarray(taps, np.float32),
                      state=jnp.asarray(fir_state))
    return y[..., ::m], phase_out, st


@cjit
def _band_compose_block(chans, centers, taps: tuple, m: int, fs_out: float):
    """Interpolate C channel-rate signals ×m, mix each to its center, sum —
    one device program (the TX mirror of _channelize_block)."""
    x = jnp.asarray(chans)
    c, n = x.shape[-2], x.shape[-1]
    xz = jnp.zeros(x.shape[:-1] + (n * m,), x.dtype)
    xz = xz.at[..., ::m].set(x)
    t = np.asarray(taps, np.float32) * m          # restore zero-stuff power
    y = fir_filter_aligned(xz, t)
    f = jnp.asarray(centers, jnp.float32)
    w = jnp.float32(_TAU / fs_out) * f            # rad/sample, +center mix
    k = jnp.arange(1, n * m + 1, dtype=jnp.float32)
    ph = w[:, None] * k
    return jnp.sum(y * jnp.exp(1j * ph), axis=-2).astype(jnp.complex64)


def band_compose(chans, centers_hz, fs_out: float, fs_in: float,
                 passband_hz: float | None = None,
                 stopband_db: float = 60.0) -> np.ndarray:
    """Compose C channel-rate signals into ONE wideband capture: zero-stuff
    ×(fs_out/fs_in), anti-image lowpass (batched over channels), mix each
    channel to its center, sum — the TX mirror of :class:`Channelizer` and
    the gateway transmitter's back end (beyond the reference, which has no
    multi-signal composition). Group-delay-free: channel sample k lands at
    wideband sample k·m.

    ``chans``: (C, n) complex at ``fs_in``; ``centers_hz``: (C,) offsets
    from the output center; ``fs_out`` must be an integer multiple of
    ``fs_in``. Returns (n·m,) complex64."""
    x = np.asarray(chans)
    if x.ndim != 2:
        raise ValueError("chans must be (C, n)")
    m = fs_out / fs_in
    if abs(m - round(m)) > 1e-9 or round(m) < 1:
        raise ValueError(f"fs_out ({fs_out}) must be an integer multiple "
                         f"of fs_in ({fs_in})")
    m = int(round(m))
    centers = np.asarray(list(centers_hz), np.float32)
    if centers.shape != (x.shape[0],):
        raise ValueError("need one center per channel")
    if np.any(np.abs(centers) >= fs_out / 2.0):
        raise ValueError("channel centers must sit inside ±fs_out/2")
    if m == 1:
        taps = np.ones(1, np.float32)
    else:
        if passband_hz is None:
            passband_hz = 0.4 * fs_in
        pass_n = float(passband_hz) / fs_out
        stop_n = 0.5 * fs_in / fs_out
        trans = max(stop_n - pass_n, 1e-4)
        taps = kaiser_lowpass_taps(kaiser_num_taps(trans, stopband_db),
                                   0.5 * (pass_n + stop_n), stopband_db)
    return np.asarray(_band_compose_block(x.astype(np.complex64), centers,
                                          tuple(taps.tolist()), m,
                                          float(fs_out)))


class Channelizer:
    """Streaming C-channel extraction from one wideband stream.

    ``fs_wide`` must be an integer multiple of ``fs_out``. ``passband_hz``
    is the one-sided bandwidth each channel must pass undistorted
    (default 0.4·fs_out); the anti-alias Kaiser lowpass puts its −6 dB
    point midway between that and the output Nyquist.
    """

    def __init__(self, fs_wide: float, fs_out: float,
                 centers_hz: Sequence[float],
                 passband_hz: float | None = None,
                 stopband_db: float = 60.0) -> None:
        m = fs_wide / fs_out
        if abs(m - round(m)) > 1e-9 or round(m) < 1:
            raise ValueError(
                f"fs_wide ({fs_wide}) must be an integer multiple of the "
                f"output rate ({fs_out})")
        self.m = int(round(m))
        self.fs_wide = float(fs_wide)
        self.fs_out = float(fs_out)
        self.centers_hz = np.asarray(list(centers_hz), np.float32)
        if self.centers_hz.ndim != 1 or self.centers_hz.size == 0:
            raise ValueError("centers_hz must be a non-empty 1-D sequence")
        if np.any(np.abs(self.centers_hz) >= fs_wide / 2.0):
            raise ValueError("channel centers must sit inside ±fs_wide/2")
        if passband_hz is None:
            passband_hz = 0.4 * fs_out
        pass_n = float(passband_hz) / fs_wide
        stop_n = 0.5 * fs_out / fs_wide
        trans = max(stop_n - pass_n, 1e-4)
        num_taps = kaiser_num_taps(trans, stopband_db)
        self.taps = kaiser_lowpass_taps(num_taps, 0.5 * (pass_n + stop_n),
                                        stopband_db)
        c = self.centers_hz.size
        self._phase = np.zeros(c, np.float32)
        self._state = np.zeros((c, len(self.taps) - 1), np.complex64)
        self._rem = np.zeros(0, np.complex64)
        # fixed internal block, aligned to absolute sample offsets: output
        # is exactly independent of how callers chunk their feeds, and the
        # f32 in-block phase ramp stays ≤ ~0.006 rad of rounding (the
        # carried remainder re-anchors the phase every block)
        self._block = self.m * 4096

    @property
    def num_channels(self) -> int:
        return int(self.centers_hz.size)

    def __len__(self) -> int:
        return len(self._rem)

    def _run(self, block: np.ndarray) -> np.ndarray:
        y, ph, st = _channelize_block(block, self.centers_hz, self._phase,
                                      self._state, tuple(self.taps.tolist()),
                                      self.m, self.fs_wide)
        self._phase = np.asarray(ph)
        self._state = np.asarray(st)
        return np.asarray(y)

    def push(self, iq) -> np.ndarray:
        """Feed wideband IQ, get (C, n_new) baseband output (n_new may be
        0 while input buffers up to an internal block)."""
        buf = np.concatenate([self._rem, sanitize_iq(iq)])
        n_blocks = len(buf) // self._block
        take = n_blocks * self._block
        self._rem = buf[take:]
        if not take:
            return np.zeros((self.num_channels, 0), np.complex64)
        outs = [self._run(buf[i * self._block:(i + 1) * self._block])
                for i in range(n_blocks)]
        return outs[0] if n_blocks == 1 else np.concatenate(outs, axis=-1)

    def flush(self) -> np.ndarray:
        """Drain the remainder (zero-padded up to a decimation multiple);
        empty if nothing is buffered."""
        if not len(self._rem):
            return np.zeros((self.num_channels, 0), np.complex64)
        take = -(-len(self._rem) // self.m) * self.m
        block = np.zeros(take, np.complex64)
        block[: len(self._rem)] = self._rem
        self._rem = np.zeros(0, np.complex64)
        return self._run(block)
