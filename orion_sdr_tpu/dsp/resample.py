"""Polyphase rational resampling (beyond the reference, whose only rate
changer is the integer ``FirDecimator``, dsp/decim.rs:10-77).

``resample`` / ``Resampler`` change the sample rate by any rational up/down
(48 kHz → 44.1 kHz is 147/160, symbol-rate matching, fractional decimation
of wideband captures). Design: upfirdn is ONE XLA
``conv_general_dilated`` call — ``lhs_dilation=up`` zero-stuffs the input
inside the conv (never materializing the ×up stream), ``window_strides=down``
decimates the output, and the anti-image/anti-alias Kaiser lowpass rides the
conv path. Streaming is chunk-boundary invariant: the carried state is
the input tail plus the output-grid phase, exactly the halo a time-sharded
long capture would exchange.
"""

from __future__ import annotations

from math import gcd

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .fir import kaiser_lowpass_taps


def resample_taps(up: int, down: int, taps_per_phase: int = 24,
                  stopband_db: float = 70.0) -> np.ndarray:
    """Kaiser anti-image/anti-alias lowpass for an up/down resampler,
    designed at the ×up internal rate: cutoff = 0.5/max(up, down) of that
    rate, ``taps_per_phase`` taps in each of the ``up`` polyphase legs,
    DC gain ``up`` (so a constant input keeps its level through the
    zero-stuffing)."""
    up, down = int(up), int(down)
    g = gcd(up, down)
    up, down = up // g, down // g
    n = taps_per_phase * up
    n |= 1  # symmetric
    taps = kaiser_lowpass_taps(n, 0.5 / max(up, down), stopband_db)
    return (taps * up / taps.sum()).astype(np.float32)


def _upfirdn_strided(xp, taps, up: int, down: int, lead: int, n_out: int):
    """Core correlation: y[t] = Σₖ h[k]·z[lead + t·down − k] over the
    zero-stuffed stream z (z[i·up] = xp[i]); one conv_general_dilated."""
    w = jnp.asarray(taps[::-1].copy(), jnp.float32)
    ell0 = lead - (len(taps) - 1)   # first correlation start index in z

    def corr(r):
        lhs = r.reshape((-1,) + r.shape[-1:])[:, None, :]
        out = lax.conv_general_dilated(
            lhs, w[None, None, :], window_strides=(down,),
            padding=((-ell0, len(taps) + n_out * down),),
            lhs_dilation=(up,))
        return out[:, 0, :n_out].reshape(r.shape[:-1] + (n_out,))

    if jnp.iscomplexobj(xp):
        return (corr(xp.real.astype(jnp.float32)) +
                1j * corr(xp.imag.astype(jnp.float32))).astype(jnp.complex64)
    return corr(xp.astype(jnp.float32))


def resample(x, up: int, down: int, taps=None):
    """One-shot rational resample, group-delay compensated: output sample m
    lands on input time m·down/up (y[m] ≈ x(m·down/up)), length
    ⌈n·up/down⌉. ``taps``: optional prototype from :func:`resample_taps`
    (the default 24-taps-per-phase 70 dB design otherwise)."""
    up, down = int(up), int(down)
    g = gcd(up, down)
    up, down = up // g, down // g
    if up < 1 or down < 1:
        raise ValueError("up and down must be positive")
    x = jnp.asarray(x)
    n = x.shape[-1]
    if taps is None:
        taps = resample_taps(up, down)
    n_out = -(-n * up // down)
    gd = (len(taps) - 1) // 2
    # y[m] = y_full[m·down + gd] where y_full is the causal conv over z
    return _upfirdn_strided(x, np.asarray(taps, np.float32), up, down,
                            lead=gd, n_out=n_out)


class Resampler:
    """Streaming rational resampler (chunk-boundary invariant).

    ``feed`` returns the causal output (lagging by the prototype's group
    delay, like ``fir_apply``); the concatenation over any chunking equals
    the one-shot causal resample of the concatenated input. ``flush``
    drains the group-delay tail.
    """

    def __init__(self, up: int, down: int, taps=None,
                 taps_per_phase: int = 24, stopband_db: float = 70.0):
        g = gcd(int(up), int(down))
        self.up, self.down = int(up) // g, int(down) // g
        if self.up < 1 or self.down < 1:
            raise ValueError("up and down must be positive")
        self.taps = (np.asarray(taps, np.float32) if taps is not None
                     else resample_taps(self.up, self.down, taps_per_phase,
                                        stopband_db))
        # input tail long enough that every future output's window is local
        self._t = -(-(len(self.taps) - 1) // self.up)
        self._tail = None
        self._m_next = 0          # next output index on the global grid
        self._n_in = 0            # total inputs consumed

    def feed(self, x) -> np.ndarray:
        x = np.asarray(x)
        if x.shape[-1] == 0:
            return x[..., :0]
        if self._tail is None:
            self._tail = np.zeros(x.shape[:-1] + (self._t,), x.dtype)
        xp = np.concatenate([self._tail, x], axis=-1)
        self._n_in += x.shape[-1]
        # outputs m with m·down < n_in·up (causal: window fully in the past)
        m_stop = -(-self._n_in * self.up // self.down)
        n_out = m_stop - self._m_next
        if n_out <= 0:
            self._tail = xp[..., xp.shape[-1] - self._t:]
            return x[..., :0]
        # local zero-stuffed coordinate of global position m_next·down
        lead = (self._m_next * self.down
                - (self._n_in - x.shape[-1] - self._t) * self.up)
        y = np.asarray(_upfirdn_strided(
            jnp.asarray(xp), self.taps, self.up, self.down, lead, n_out))
        self._m_next = m_stop
        self._tail = xp[..., xp.shape[-1] - self._t:]
        return y

    def flush(self) -> np.ndarray:
        """Drain the outputs still inside the filter (feeds the group-delay
        worth of zeros), then reset to a fresh stream."""
        if self._tail is None:
            return np.zeros(0, np.float32)
        pad = -(-(len(self.taps) - 1) // self.up)
        out = self.feed(np.zeros(self._tail.shape[:-1] + (pad,),
                                 self._tail.dtype))
        self._tail = None
        self._m_next = 0
        self._n_in = 0
        return out
