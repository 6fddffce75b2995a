"""ADS-B 1090ES receiver (beyond the reference): envelope → preamble
matched filter → candidate starts → per-chip integrate → PPM bit decisions
→ CRC-gated DF17 decode → CPR pairing.

Design: the envelope, the preamble correlation, and the per-chip sums
for EVERY candidate run as batched device programs; only the top-k
candidate selection and the bit/CRC layer are host-side. The CRC-24 is the
real detector — preamble correlation only ranks candidates, so the
threshold can sit low without false decodes."""

from __future__ import annotations

from typing import List

import numpy as np
import jax.numpy as jnp

from ..dsp.device import cjit as _cjit
from ..modulate.adsb import (ADSB_CHIP_RATE, PREAMBLE_CHIPS, FRAME_CHIPS)
from ..codec.adsb import AdsbMessage, adsb_decode_frame, adsb_pair_positions


@_cjit
def _envelope_and_score(re, im, m: int):
    """|iq| and the preamble correlation score per sample (normalized by
    local energy so strong frames don't mask weak ones)."""
    env = jnp.sqrt(re * re + im * im).astype(jnp.float32)
    tpl = np.repeat(PREAMBLE_CHIPS, m)        # concrete design data
    tpl = (tpl / np.sqrt(np.sum(tpl * tpl))).astype(np.float32)
    from ..dsp.fir import _conv_valid_f32
    pad = [(0, 0)] * (env.ndim - 1) + [(0, len(tpl) - 1)]
    envp = jnp.pad(env, pad)
    corr = _conv_valid_f32(envp, tpl[::-1])
    # local energy over the same window
    energy = _conv_valid_f32(envp * envp, np.ones(len(tpl), np.float32))
    score = corr / jnp.sqrt(jnp.maximum(energy, 1e-12))
    return env, score.astype(jnp.float32)


@_cjit
def _chip_sums(env, starts, m: int):
    """(k,) candidate starts → (k, FRAME_CHIPS) per-chip sums."""
    offs = jnp.arange(FRAME_CHIPS * m)
    idx = jnp.asarray(starts)[:, None] + offs[None, :]
    idx = jnp.clip(idx, 0, env.shape[-1] - 1)
    seg = env[idx].reshape(len(starts), FRAME_CHIPS, m)
    return jnp.sum(seg, axis=-1)


def adsb_decode_capture(iq, fs: float, max_candidates: int = 256,
                        score_threshold: float = 0.55) -> List[AdsbMessage]:
    """Complex capture → all CRC-valid DF17 messages, CPR pairs resolved.

    ``score_threshold`` is the normalized preamble correlation (1.0 =
    perfect isolated preamble); the default passes weak/overlapped frames
    and lets the CRC adjudicate."""
    z = np.asarray(iq)
    if z.ndim != 1:
        raise ValueError("adsb_decode_capture takes a 1-D capture")
    m = fs / ADSB_CHIP_RATE
    if abs(m - round(m)) > 1e-9 or round(m) < 1:
        raise ValueError(f"fs must be an integer multiple of 2 MHz, got {fs}")
    m = int(round(m))
    if len(z) < FRAME_CHIPS * m:
        return []
    env, score = _envelope_and_score(
        np.ascontiguousarray(z.real, np.float32),
        np.ascontiguousarray(z.imag, np.float32), m)
    env, score = np.asarray(env), np.asarray(score)
    # local maxima of the score above threshold, at most one per half-chip
    valid_to = len(score) - FRAME_CHIPS * m + 1
    s = score[:max(valid_to, 0)]
    if s.size == 0:
        return []
    left = np.concatenate([[-np.inf], s[:-1]])
    right = np.concatenate([s[1:], [-np.inf]])
    cand = np.flatnonzero((s >= left) & (s > right) & (s > score_threshold))
    if cand.size == 0:
        return []
    if cand.size > max_candidates:
        cand = cand[np.argsort(s[cand])[::-1][:max_candidates]]
        cand = np.sort(cand)
    sums = np.asarray(_chip_sums(env, cand.astype(np.int32), m))
    data = sums[:, 16:].reshape(len(cand), 112, 2)
    bits = (data[:, :, 0] > data[:, :, 1]).astype(np.uint8)
    out: List[AdsbMessage] = []
    last_pos: dict = {}
    for row, pos in zip(bits, cand):
        msg = adsb_decode_frame(row)
        if msg is None:
            continue
        # identical bits within one frame duration = the same transmission
        # detected at adjacent correlation peaks; farther apart = a genuine
        # repeat (ADS-B repeats messages every ~0.5 s)
        key = row.tobytes()
        if key in last_pos and int(pos) - last_pos[key] < FRAME_CHIPS * m:
            continue
        last_pos[key] = int(pos)
        out.append(msg)
    adsb_pair_positions(out)
    return out
