"""Multi-channel COFDM band receive (beyond-reference).

The reference's `OfdmFrameStreamDemod` (demodulate/ofdm_frame.rs:695-893)
receives ONE link at baseband. A gateway receiver sees a wideband capture
carrying many COFDM channels at known centers; here the
:class:`~orion_sdr_tpu.dsp.channelizer.Channelizer` extracts every
channel in ONE batched device program and only the per-channel
acquire/decode loops run on host. Throughput scaling:
adding channels widens the batch, it does not add passes.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Union

import numpy as np

from ..dsp.channelizer import Channelizer
from ..ofdm import OfdmConfig
from ..sync.ofdm_sync import OfdmPreamble
from .types import McsTable, RxError
from .demodulator import OfdmFrameStreamDemod, RxFrame


class OfdmFrameBandStreamDemod:
    """Streaming COFDM receive of C channels from one wideband capture.

    ``fs_wide`` must be an integer multiple of ``cfg.fs``; every channel
    runs the same link config. ``feed`` takes wideband IQ chunks (any
    size — chunk-boundary invariant) and returns results per channel;
    per-channel streams hold the usual Incomplete/Failed semantics.
    """

    def __init__(self, cfg: OfdmConfig, mcs_table: McsTable,
                 preamble: OfdmPreamble, centers_hz: Sequence[float],
                 fs_wide: float, score_threshold: float = 0.5,
                 stopband_db: float = 60.0) -> None:
        self.cfg = cfg
        plan = cfg.carrier_plan
        occ_hz = plan.occupied_half_carriers() / plan.n_fft * cfg.fs
        self.channelizer = Channelizer(fs_wide, cfg.fs, centers_hz,
                                       passband_hz=occ_hz,
                                       stopband_db=stopband_db)
        self.streams = [OfdmFrameStreamDemod(cfg, mcs_table, preamble,
                                             score_threshold)
                        for _ in range(self.channelizer.num_channels)]

    @property
    def centers_hz(self) -> np.ndarray:
        return self.channelizer.centers_hz

    def __len__(self) -> int:
        return len(self.channelizer)

    def _drain(self, y: np.ndarray) -> Dict[int, List[Union[RxFrame,
                                                            RxError]]]:
        out: Dict[int, List[Union[RxFrame, RxError]]] = {}
        if y.shape[-1]:
            for c, s in enumerate(self.streams):
                res = s.feed(y[c])
                if res:
                    out[c] = res
        return out

    def feed(self, iq) -> Dict[int, List[Union[RxFrame, RxError]]]:
        """Feed wideband IQ; returns {channel_index: new results} for
        channels that produced anything this call."""
        return self._drain(self.channelizer.push(iq))

    def flush(self) -> Dict[int, List[Union[RxFrame, RxError]]]:
        """Process the sub-decimation remainder and drain every
        per-channel stream."""
        out = self._drain(self.channelizer.flush())
        for c, s in enumerate(self.streams):
            res = s.flush()
            if res:
                out.setdefault(c, []).extend(res)
        return out
