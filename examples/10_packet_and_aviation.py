"""Packet & aviation modes: decode a busy ADS-B sky, an APRS/AX.25 packet
burst, and an RTTY CQ call — three classic digital monitoring tasks.

Run: python examples/10_packet_and_aviation.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from orion_sdr_tpu.runtime import use_compile_cache  # noqa: E402

use_compile_cache()

import numpy as np
import orion_sdr_tpu as sdr

rng = np.random.default_rng(1)

# ── 1. ADS-B: four aircraft in one 1090 MHz capture ──────────────────────────
frames = [
    sdr.adsb_encode_identification(0x4840D6, "KLM1023"),
    sdr.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, odd=0),
    sdr.adsb_encode_position(0x4840D6, 52.2572, 3.91937, 38000, odd=1),
    sdr.adsb_encode_velocity(0x4840D6, 450.0, 245.0),
    sdr.adsb_encode_identification(0xA0B1C2, "UAL89"),
    sdr.adsb_encode_position(0xA0B1C2, 40.6413, -73.7781, 12000, odd=0),
    sdr.adsb_encode_position(0xA0B1C2, 40.6413, -73.7781, 12000, odd=1),
]
fs_adsb = 8_000_000.0
iq = sdr.adsb_mod(frames, fs_adsb,
                  amplitudes=[1.0, 0.9, 0.9, 0.8, 0.35, 0.3, 0.3])
iq = iq + ((rng.standard_normal(len(iq)) + 1j * rng.standard_normal(len(iq)))
           .astype(np.complex64) * 0.05)
print("ADS-B sky:")
for m in sdr.adsb_decode_capture(iq, fs_adsb):
    what = m.callsign or (f"pos {m.position[0]:.4f},{m.position[1]:.4f} "
                          f"@ {m.altitude_ft} ft" if m.position
                          else f"alt {m.altitude_ft} ft" if m.altitude_ft
                          else f"gs {m.ground_speed_kt:.0f} kt "
                               f"trk {m.track_deg:.0f}°")
    print(f"  {m.icao:06X}  TC{m.type_code:<2}  {what}")

# ── 2. APRS over AFSK-1200, through the FM voice chain ───────────────────────
fs = 48_000.0
pkt = sdr.Ax25Frame(dest="APRS", src="W1AW-9", digis=("WIDE1-1",),
                    payload=b"!4237.14N/07120.83W>orion_sdr_tpu mobile")
audio = sdr.ax25_beacon([pkt], fs)
fm_iq, _ = sdr.fm_mod(audio * 0.5, fs, 3000.0)
back, _ = sdr.fm_demod(np.asarray(fm_iq), fs, 3000.0, 3000.0)
print("\nAPRS (through the FM chain):")
for f in sdr.ax25_decode(np.asarray(back) * 2.0, fs):
    print(f"  {f.src} > {f.dest} via {','.join(f.digis)}: "
          f"{f.payload.decode()}")

# ── 3. RTTY CQ call at 8 dB audio SNR ────────────────────────────────────────
fs_r = 11_025.0
tty = sdr.rtty_mod("CQ CQ CQ DE W1AW W1AW K", fs_r)
tty = tty + rng.standard_normal(len(tty)).astype(np.float32) \
    * np.sqrt(float(np.mean(tty ** 2)) / 10 ** 0.8)
print("\nRTTY:", repr(sdr.rtty_decode(tty, fs_r)))

# ── 4. AIS: two ships on the harbor channel ──────────────────────────────────
ships = [sdr.AisPosition(mmsi=211234567, lat=53.5421, lon=9.9845,
                         sog_kt=12.3, cog_deg=87.5, heading_deg=88),
         sdr.AisPosition(mmsi=244000111, lat=53.5380, lon=9.9710,
                         sog_kt=0.2, cog_deg=310.0, msg_type=3)]
ais_iq = sdr.ais_mod(ships)
ais_iq = ais_iq + ((rng.standard_normal(len(ais_iq))
                    + 1j * rng.standard_normal(len(ais_iq)))
                   .astype(np.complex64) * np.sqrt(0.1 / 2))   # 10 dB
print("\nAIS (GMSK 9600):")
for s in sdr.ais_decode(ais_iq, 96_000.0):
    print(f"  MMSI {s.mmsi}  {s.lat:.4f},{s.lon:.4f}  "
          f"{s.sog_kt:.1f} kt  COG {s.cog_deg:.1f}°")

# ── 5. CSS (LoRa-style): a sensor beacon below the noise floor ───────────────
beacon = sdr.css_mod(b"sensor-7: 21.4C 1013hPa", sf=9)
z = np.concatenate([np.zeros(400, np.complex64), beacon])
z = z + ((rng.standard_normal(len(z)) + 1j * rng.standard_normal(len(z)))
         .astype(np.complex64) * np.sqrt(10 ** 0.5 / 2))       # −5 dB!
frame = sdr.css_demod(z, sf=9)
print(f"\nCSS @ −5 dB IQ SNR: {frame.payload.decode()!r} "
      f"(crc_ok={frame.crc_ok})")
