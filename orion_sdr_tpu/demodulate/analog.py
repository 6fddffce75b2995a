"""Analog demodulators: CW / AM / SSB / FM / PM.

Batched JAX versions of the reference's src/demodulate/{cw,am,ssb,fm,pm}.rs.
Every per-sample IIR loop becomes a parallel scan; the quadrature
discriminators are one fused elementwise pass (delay-conjugate product +
arctan2 — we use exact arctan2 instead of the reference's 5th-order minimax
approximation, util.rs:305, which only helps accuracy).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..dsp.device import cjit as _cjit

from ..dsp.osc import rotate, mix_usb
from ..dsp.fir import kaiser_lowpass_taps, kaiser_num_taps
from ..util import atan2_approx
from ..dsp.iir import (
    design_butter_lp, dc_pole, lp_cascade, lp_dc_cascade, LpDcState, biquad_init,
)
from ..dsp.recurrence import first_order


@_cjit
def cw_demod(iq, fs, env_bw_hz=300.0, gain=1.0, y0=0.0):
    """Envelope detector: |z| through a one-pole LP (ref: demodulate/cw.rs:8-50).

    Returns (audio, lp_state).
    """
    z = jnp.asarray(iq)
    mag = jnp.abs(z).astype(jnp.float32)
    a = float(np.exp(-2.0 * np.pi * max(env_bw_hz, 1.0) / fs))
    y, y_last = first_order(a, (1.0 - a) * mag, y0=y0)
    return gain * y, y_last


@_cjit
def cw_envelope_multi(iq, fs, carriers_hz, env_bw_hz=100.0,
                      env_rate_hz=1000.0):
    """K keying envelopes from ONE capture in one device program.

    Beyond-reference (demodulate/cw.rs:8-50 is one envelope per Block
    instance, already mixed to baseband): rotate the capture to every
    carrier at once, narrowband-lowpass the complex rows BEFORE the
    magnitude (so the noise bandwidth is ``env_bw_hz``, not fs/2, and a
    carrier estimate off by ≪ env_bw_hz costs nothing), then box-average
    down to ``env_rate_hz``. The decimated grid is what the host Morse
    classifier consumes — run lengths only need ~1 ms resolution while the
    dit at 40 wpm is 30 ms.

    Returns (K, n_env) float32 envelopes.
    """
    z = jnp.asarray(iq)
    f = jnp.asarray(carriers_hz, jnp.float32).reshape(-1)
    m = max(int(round(fs / max(env_rate_hz, 1.0))), 1)
    k = f.shape[0]
    if z.shape[-1] < m or k == 0:
        return jnp.zeros((k, 0), jnp.float32)
    zb, _ = rotate(z[None, :], -f[:, None], fs)              # (K, n)
    # Kaiser design with an EXPLICIT 60 dB stopband one env_bw out: in a
    # band decode a 20 dB-stronger neighbor a few hundred Hz away must not
    # key this row's envelope (the Hann fir_lowpass_design transition is
    # ~3.3·fs/ntaps wide — far too shallow here).
    nt = kaiser_num_taps(env_bw_hz / fs, 60.0)
    taps = jnp.asarray(kaiser_lowpass_taps(nt, env_bw_hz / fs, 60.0))
    zb = jax.vmap(lambda r: jnp.convolve(r, taps, mode="same"))(zb)
    mag = jnp.abs(zb).astype(jnp.float32)
    n_env = mag.shape[-1] // m
    return mag[:, : n_env * m].reshape(k, n_env, m).mean(axis=-1)


@_cjit
def am_demod(iq, fs, audio_bw_hz, method="power_sqrt", abs_k=(0.947543636291, 0.392485425092),
             state: LpDcState | None = None):
    """AM envelope demod (ref: demodulate/am.rs:9-46).

    ``power_sqrt``: LP4(|z|²) → sqrt → DC block (highest fidelity).
    ``abs_approx``: k1·|I| + k2·|Q| → LP4 → DC block (cheaper; here both
    are one fused pass, the option is kept for output parity).
    """
    z = jnp.asarray(iq)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    r = dc_pole(fs, 2.0)
    if method == "power_sqrt":
        p = (z.real * z.real + z.imag * z.imag).astype(jnp.float32)
        return lp_dc_cascade(p, c, r, state=state, map_fn=lambda v: jnp.sqrt(jnp.maximum(v, 0.0)))
    k1, k2 = abs_k
    e = (k1 * jnp.abs(z.real) + k2 * jnp.abs(z.imag)).astype(jnp.float32)
    return lp_dc_cascade(e, c, r, state=state)


class AmStation(NamedTuple):
    """One AM transmission recovered by :func:`am_band_demod`."""
    center_hz: float
    audio: np.ndarray
    carrier_level: float
    fs_audio: float


def am_band_demod(iq, fs, stations_hz=None, audio_bw_hz: float = 5000.0,
                  method: str = "power_sqrt",
                  scan_threshold_db: float = 10.0,
                  min_station_bw_hz: float = 2000.0) -> list:
    """Gateway receive of a whole AM band (MW/SW broadcast monitoring):
    scan (or take) carrier centers, channelize every station out of the
    wideband capture in ONE batched device program, envelope-demodulate all
    of them together. Envelope detection is CFO-insensitive, so scan
    centroid error does not degrade audio. Beyond the reference, whose AM
    demod is one channel at a time (demodulate/am.rs).

    Returns [AmStation] with audio at fs/m (m chosen so the channel rate
    lands just above 4·audio_bw)."""
    from ..dsp.channelizer import Channelizer
    z = np.asarray(iq)
    if z.ndim != 1:
        raise ValueError("am_band_demod takes a 1-D wideband capture")
    if stations_hz is None:
        from ..util import spectrum_scan
        segs = spectrum_scan(z, fs, threshold_db=scan_threshold_db,
                             min_bw_hz=min_station_bw_hz)
        stations_hz = [s.center_hz for s in segs]
    stations_hz = list(stations_hz)
    if not stations_hz:
        return []
    m = max(1, int(fs // (4.0 * audio_bw_hz)))
    ch_fs = fs / m
    chan = Channelizer(fs, ch_fs, stations_hz,
                       passband_hz=audio_bw_hz * 1.2)
    parts = [chan.push(z), chan.flush()]
    chans = np.concatenate([p for p in parts if p.shape[-1]], axis=-1)
    audio, _ = am_demod(chans, ch_fs, audio_bw_hz, method=method)
    audio = np.asarray(audio)
    levels = np.mean(np.abs(chans), axis=-1)
    # blind scans can surface leakage skirts of strong carriers as
    # segments; an AM station without meaningful carrier power in its own
    # channel is an artifact (gate at 3% of the strongest station)
    gate = 0.03 * float(levels.max()) if stations_hz else 0.0
    return [AmStation(center_hz=float(c), audio=audio[i],
                      carrier_level=float(levels[i]), fs_audio=ch_fs)
            for i, c in enumerate(stations_hz) if levels[i] >= gate]


class SsbStation(NamedTuple):
    """One SSB transmission recovered by :func:`ssb_band_demod`."""
    center_hz: float
    audio: np.ndarray
    fs_audio: float


def ssb_band_demod(iq, fs, stations_hz, audio_bw_hz: float = 2700.0,
                   audio_if_hz: float = 1500.0, usb: bool = True) -> list:
    """Gateway receive of several SSB voice channels from one wideband
    capture: channelize every dial frequency in ONE batched device program,
    then product-detect all channels together (beyond the reference, whose
    SSB demod is one channel at a time, demodulate/ssb.rs).

    ``stations_hz``: the dial (suppressed-carrier) frequencies relative to
    the capture center — SSB has no carrier to find blind, so the tuning
    plan is the caller's (a band plan, or :func:`spectrum_scan` segment
    edges). ``audio_if_hz``/``usb`` mirror ssb_mod's conventions and are
    shared by the channel list. Audio at fs/m (m near 4·audio_bw)."""
    from ..dsp.channelizer import Channelizer
    z = np.asarray(iq)
    if z.ndim != 1:
        raise ValueError("ssb_band_demod takes a 1-D wideband capture")
    stations_hz = list(stations_hz)
    if not stations_hz:
        return []
    m = max(1, int(fs // (4.0 * audio_bw_hz)))
    ch_fs = fs / m
    # a USB signal occupies [dial+if, dial+if+bw]: center the channel on
    # the middle of that sideband (mirrored for LSB)
    half = audio_if_hz + audio_bw_hz / 2.0
    offs = half if usb else -half
    chan = Channelizer(fs, ch_fs, [c + offs for c in stations_hz],
                       passband_hz=audio_bw_hz * 0.7)
    parts = [chan.push(z), chan.flush()]
    chans = np.concatenate([p for p in parts if p.shape[-1]], axis=-1)
    if not usb:
        chans = np.conj(chans)       # an LSB channel conjugates into USB
    # in-channel the audio tone f sits at if + f − offs ⇒ BFO = if − offs
    audio, _ = ssb_demod(chans, ch_fs,
                         bfo_hz=audio_if_hz - abs(offs),
                         audio_bw_hz=audio_bw_hz)
    audio = np.asarray(audio)
    return [SsbStation(center_hz=float(c), audio=audio[i], fs_audio=ch_fs)
            for i, c in enumerate(stations_hz)]


class SsbDemodState(NamedTuple):
    filt: LpDcState
    bfo_phase: jnp.ndarray


@_cjit
def ssb_demod(iq, fs, bfo_hz, audio_bw_hz, state: SsbDemodState | None = None):
    """Product detector: I·cos + Q·sin with a BFO, then LP+DC
    (ref: demodulate/ssb.rs:9-70)."""
    z = jnp.asarray(iq)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    r = dc_pole(fs, 2.0)
    phase0 = state.bfo_phase if state is not None else 0.0
    y, bfo_phase = mix_usb(z, bfo_hz, fs, phase0)
    audio, filt = lp_dc_cascade(y, c, r, state=state.filt if state is not None else None)
    return audio, SsbDemodState(filt=filt, bfo_phase=bfo_phase)


class QuadDemodState(NamedTuple):
    prev: jnp.ndarray       # previous complex sample
    lp: tuple               # (BiquadState, BiquadState) LpCascade state
    xlate_phase: jnp.ndarray


def _delay_conj_product(z, prev):
    zprev = jnp.concatenate([prev[..., None], z[..., :-1]], axis=-1)
    return z * jnp.conj(zprev)


@_cjit
def fm_demod(iq, fs, deviation_hz, audio_bw_hz, translate_hz=None,
             state: QuadDemodState | None = None):
    """Quadrature discriminator: angle(z·conj(z₋₁))·(1/dev) → LP4
    (ref: demodulate/fm.rs:12-90). Returns (audio, state)."""
    z = jnp.asarray(iq)
    if state is None:
        state = QuadDemodState(
            prev=jnp.ones(z.shape[:-1], jnp.complex64),
            lp=(biquad_init(z.shape[:-1]), biquad_init(z.shape[:-1])),
            xlate_phase=jnp.zeros(z.shape[:-1], jnp.float32),
        )
    if z.shape[-1] == 0:
        return jnp.zeros(z.shape[:-1] + (0,), jnp.float32), state
    xlate_phase = state.xlate_phase
    if translate_hz is not None:
        # multiply by conj of a +translate_hz phasor == rotate by -translate_hz
        z, xlate_phase = rotate(z, -translate_hz, fs, xlate_phase)
    k = 1.0 / max(deviation_hz, 1.0)
    prod = _delay_conj_product(z, state.prev)
    disc = (atan2_approx(prod.imag, prod.real) * k).astype(jnp.float32)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    audio, lp = lp_cascade(disc, c, state.lp)
    return audio, QuadDemodState(prev=z[..., -1], lp=lp, xlate_phase=xlate_phase)


@_cjit
def pm_demod(iq, fs, k, audio_bw_hz, state: QuadDemodState | None = None):
    """PM via phase difference (ref: demodulate/pm.rs:12-80). Returns (audio, state)."""
    z = jnp.asarray(iq)
    if state is None:
        state = QuadDemodState(
            prev=jnp.ones(z.shape[:-1], jnp.complex64),
            lp=(biquad_init(z.shape[:-1]), biquad_init(z.shape[:-1])),
            xlate_phase=jnp.zeros(z.shape[:-1], jnp.float32),
        )
    if z.shape[-1] == 0:
        return jnp.zeros(z.shape[:-1] + (0,), jnp.float32), state
    prod = _delay_conj_product(z, state.prev)
    disc = (k * atan2_approx(prod.imag, prod.real)).astype(jnp.float32)
    c = design_butter_lp(fs, audio_bw_hz * 0.9)
    audio, lp = lp_cascade(disc, c, state.lp)
    return audio, QuadDemodState(prev=z[..., -1], lp=lp, xlate_phase=state.xlate_phase)
