"""Streaming runtime: the reference's ISR/loop split as a host feeder loop
(``radiodsp_sdr_rx_tpu/models/streaming.py``).

The reference couples a hard-real-time audio ISR to a best-effort main loop
through block queues. Here the same structure is a ``StreamingReceiver``: a
producer (capture thread, file reader, or caller) pushes IQ into the native
lock-free ring (``utils/native_io.IQRing``, built from ``csrc/rdsp_io.cpp``);
the consumer side drains fixed-size blocks through the ``Receiver`` on its
device, carrying ``ReceiverState`` (and optionally ``ScopeState`` metrics)
across blocks. Back-pressure is explicit: ring overruns are counted, not
hidden — the observable version of the reference's silent block dropping
when ``loop()`` falls behind (RDSP_convolutional.h:231).

Each block goes to the device once; the scope reads the receiver's audio
there, and the audio comes back to the host once a block, after the scope
has been queued.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.metrics import analyze_jit, scope_init
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver


class StreamingReceiver:
    """Block-streaming receiver over the native IQ ring buffer.

    >>> sr = StreamingReceiver(cfg, block=16384)
    >>> sr.push(iq_chunk)          # producer side (any thread)
    >>> audio = sr.process_available()   # consumer side: every full block
    >>> sr.stats                   # pushed/popped/dropped counters

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions.
    """

    def __init__(
        self,
        config: ReceiverConfig,
        block: int = 16384,
        ring_capacity: int = 1 << 17,
        metrics: bool = False,
        device=None,
    ):
        from radiodsp_sdr_rx_tpu_torch.utils import native_io

        if block % 128:
            raise ValueError("block must be a multiple of 128")
        self.receiver = Receiver(config, device)
        self.device = self.receiver.device
        self.block = block
        self.metrics_enabled = metrics
        self.ring = native_io.IQRing(ring_capacity)
        self.state = self.receiver.init_state()
        self.scope = scope_init(self.device) if metrics else None
        self.last_metrics: dict | None = None
        self._lock = threading.Lock()

    # -- producer side --------------------------------------------------------

    def push(self, iq: np.ndarray) -> int:
        """Push complex64 IQ; returns samples accepted (rest counted dropped)."""
        return self.ring.push_complex(np.asarray(iq))

    def push_backpressure(self, iq: np.ndarray) -> None:
        """Push with retry until fully accepted (file/offline producers)."""
        seg = np.asarray(iq)
        while len(seg):
            accepted = self.ring.push_complex(seg)
            seg = seg[accepted:]
            if not accepted and len(seg):
                self.process_available()  # consumer must drain in this thread

    # -- consumer side --------------------------------------------------------

    def process_available(self) -> list[np.ndarray]:
        """Demodulate every full block currently in the ring."""
        outs = []
        with self._lock:
            while self.ring.available >= self.block:
                iq = torch.from_numpy(self.ring.pop_complex(self.block)).to(self.device)
                out, self.state = self.receiver.process(iq, self.state)
                if self.metrics_enabled and len(iq) % 512 == 0:
                    m, self.scope = analyze_jit(
                        iq, out["audio_l"], self.scope,
                        sample_rate=self.receiver.config.sample_rate)
                    self.last_metrics = m
                outs.append(out["audio_l"].cpu().numpy())
        return outs

    def run_file(self, iq: np.ndarray, chunk: int = 65536) -> np.ndarray:
        """Offline convenience: stream an in-memory capture through the ring
        (exercising the full producer/consumer path) and return the audio."""
        outs = []
        pos = 0
        n = (len(iq) // self.block) * self.block
        while pos < n:
            seg = np.asarray(iq[pos : pos + chunk])
            while len(seg):
                accepted = self.ring.push_complex(seg)
                seg = seg[accepted:]
                outs.extend(self.process_available())
            pos += chunk
        outs.extend(self.process_available())
        return np.concatenate(outs) if outs else np.zeros(0, np.float32)

    @property
    def stats(self) -> dict:
        return self.ring.stats

    def close(self) -> None:
        self.ring.close()
