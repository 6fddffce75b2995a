"""DVB-T MPEG-2 TS adaptation + packet-keyed energy dispersal (behavioral
spec: waveform/dvb_t_ts.rs; ETSI EN 300 744 §4.3.1).

188-byte packets (0x47 sync + 187 payload); the dispersal PRBS re-inits every
8 packets, the group-leading sync byte inverts 0x47→0xB8 (XOR 0xFF) and is
NOT clocked over, the other seven sync bytes are clocked but not randomized.

Design: the whole dispersal is one precomputed per-group PN byte plane
XORed over the packet matrix — no per-byte loop.
"""

from __future__ import annotations

from functools import lru_cache
from typing import Optional

import numpy as np

from .dvb_t import dvb_t_prbs_bytes

TS_PACKET_LEN = 188
TS_PAYLOAD_LEN = TS_PACKET_LEN - 1
TS_SYNC_BYTE = 0x47
TS_SYNC_BYTE_INVERTED = 0xB8
TS_DISPERSAL_GROUP = 8


@lru_cache(maxsize=1)
def _group_pn_plane() -> np.ndarray:
    """(8, 188) uint8 XOR plane for one dispersal group.

    Packet 0: byte 0 ^= 0xFF (sync inversion, PRBS not clocked); bytes 1..188
    take PRBS bytes 0..187. Packets 1..7: byte 0 untouched but the PRBS clocks
    over it (one byte consumed, output discarded); payload takes the next 187.
    """
    pn_stream = dvb_t_prbs_bytes(TS_PAYLOAD_LEN + 7 * TS_PACKET_LEN)
    plane = np.zeros((TS_DISPERSAL_GROUP, TS_PACKET_LEN), np.uint8)
    plane[0, 0] = TS_SYNC_BYTE ^ TS_SYNC_BYTE_INVERTED   # 0xFF
    c = 0
    plane[0, 1:] = pn_stream[c:c + TS_PAYLOAD_LEN]
    c += TS_PAYLOAD_LEN
    for p in range(1, TS_DISPERSAL_GROUP):
        c += 1                                            # clocked sync byte
        plane[p, 1:] = pn_stream[c:c + TS_PAYLOAD_LEN]
        c += TS_PAYLOAD_LEN
    return plane


def ts_energy_disperse(packets) -> np.ndarray:
    """Dispersal over whole 188-byte packets (self-inverse). Returns a new
    array; input length must be a multiple of 188."""
    p = np.asarray(packets, np.uint8)
    assert p.shape[-1] % TS_PACKET_LEN == 0, "whole TS packets required"
    n = p.shape[-1] // TS_PACKET_LEN
    plane = _group_pn_plane()
    reps = -(-n // TS_DISPERSAL_GROUP)
    pn = np.tile(plane, (reps, 1))[:n].reshape(-1)
    return p ^ pn


def ts_packetize(payload) -> np.ndarray:
    """Arbitrary bytes → whole TS packets, zero-padded final payload."""
    payload = np.asarray(payload, np.uint8)
    n_packets = max(-(-len(payload) // TS_PAYLOAD_LEN), 1)
    out = np.zeros((n_packets, TS_PACKET_LEN), np.uint8)
    out[:, 0] = TS_SYNC_BYTE
    padded = np.concatenate([payload, np.zeros(
        n_packets * TS_PAYLOAD_LEN - len(payload), np.uint8)])
    out[:, 1:] = padded.reshape(n_packets, TS_PAYLOAD_LEN)
    return out.reshape(-1)


def ts_null_packet() -> np.ndarray:
    """MPEG-2 null packet (PID 0x1FFF): 47 1F FF 10 + 184×FF stuffing."""
    pkt = np.full(TS_PACKET_LEN, 0xFF, np.uint8)
    pkt[0], pkt[1], pkt[2], pkt[3] = TS_SYNC_BYTE, 0x1F, 0xFF, 0x10
    return pkt


def ts_stuff_null_packets(ts, target_packets: int) -> np.ndarray:
    """Append null packets until at least ``target_packets`` packets."""
    ts = np.asarray(ts, np.uint8)
    assert len(ts) % TS_PACKET_LEN == 0
    have = len(ts) // TS_PACKET_LEN
    if have >= target_packets:
        return ts.copy()
    nulls = np.tile(ts_null_packet(), target_packets - have)
    return np.concatenate([ts, nulls])


def ts_depacketize(packets) -> Optional[np.ndarray]:
    """Strip sync bytes, concatenate 187-byte payloads; None if not whole or
    if any sync byte is wrong (post-un-dispersal every packet must lead with
    0x47 — the validation that makes sync bytes worth transmitting)."""
    p = np.asarray(packets, np.uint8)
    if p.size == 0 or p.size % TS_PACKET_LEN != 0:
        return None
    rows = p.reshape(-1, TS_PACKET_LEN)
    if not np.all(rows[:, 0] == TS_SYNC_BYTE):
        return None
    return rows[:, 1:].reshape(-1).copy()
