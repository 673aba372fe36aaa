"""ctypes bindings to the native host-IO runtime (``radiodsp_sdr_rx_tpu/utils/native_io.py``).

The equivalent of the reference's C++ streaming runtime (Teensy Audio queues
+ I2S DMA): a lock-free SPSC ring buffer between a capture thread and the
feeder that moves blocks to the card, with drop counters, plus CMSIS-exact
q15 conversion and streaming WAV reads. The library is the port's copy of
the source, ``csrc/rdsp_io.cpp``, built with g++ into the package's
``_build/`` at first use (``utils/build.build_host_library``); the port
never builds into or loads from the JAX package's ``native/``.
"""

from __future__ import annotations

import ctypes
import threading

import numpy as np

from radiodsp_sdr_rx_tpu_torch.utils import build

_lib = None
_lock = threading.Lock()


def ensure_built() -> str:
    """Build the shared library if its source or flags are new. Returns its path."""
    with _lock:
        return str(build.build_host_library("rdsp_io"))


def load():
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(ensure_built())
    lib.rdsp_ring_create.restype = ctypes.c_void_p
    lib.rdsp_ring_create.argtypes = [ctypes.c_size_t]
    lib.rdsp_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.rdsp_ring_push.restype = ctypes.c_size_t
    lib.rdsp_ring_push.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.rdsp_ring_pop_float.restype = ctypes.c_size_t
    lib.rdsp_ring_pop_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                        ctypes.c_void_p, ctypes.c_size_t]
    lib.rdsp_ring_available.restype = ctypes.c_size_t
    lib.rdsp_ring_available.argtypes = [ctypes.c_void_p]
    for name in ("rdsp_ring_dropped", "rdsp_ring_pushed", "rdsp_ring_popped"):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_uint64
        fn.argtypes = [ctypes.c_void_p]
    lib.rdsp_q15_to_float.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.rdsp_float_to_q15.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.rdsp_wav_open.restype = ctypes.c_void_p
    lib.rdsp_wav_open.argtypes = [ctypes.c_char_p]
    lib.rdsp_wav_sample_rate.restype = ctypes.c_uint32
    lib.rdsp_wav_sample_rate.argtypes = [ctypes.c_void_p]
    lib.rdsp_wav_channels.restype = ctypes.c_uint32
    lib.rdsp_wav_channels.argtypes = [ctypes.c_void_p]
    lib.rdsp_wav_read.restype = ctypes.c_size_t
    lib.rdsp_wav_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t]
    lib.rdsp_wav_close.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


class IQRing:
    """Lock-free SPSC IQ ring buffer (native).

    Producer pushes interleaved int16 (I,Q) pairs (the codec/capture format);
    consumer pops deinterleaved float32 with q15 scaling — the reference's
    arm_q15_to_float boundary (RDSP_convolutional.h:241-242), done natively.
    """

    def __init__(self, capacity_samples: int):
        self._lib = load()
        self._h = self._lib.rdsp_ring_create(capacity_samples)
        if not self._h:
            raise MemoryError("rdsp_ring_create failed")
        self.capacity = capacity_samples

    def push(self, interleaved_i16: np.ndarray) -> int:
        a = np.ascontiguousarray(interleaved_i16, dtype=np.int16)
        n = len(a) // 2
        return self._lib.rdsp_ring_push(self._h, a.ctypes.data, n)

    def push_complex(self, iq: np.ndarray) -> int:
        inter = np.empty(2 * len(iq), np.int16)
        inter[0::2] = np.clip(np.trunc(iq.real * 32768.0), -32768, 32767)
        inter[1::2] = np.clip(np.trunc(iq.imag * 32768.0), -32768, 32767)
        return self.push(inter)

    def pop_complex(self, n: int) -> np.ndarray:
        i = np.empty(n, np.float32)
        q = np.empty(n, np.float32)
        got = self._lib.rdsp_ring_pop_float(self._h, i.ctypes.data, q.ctypes.data, n)
        return (i[:got] + 1j * q[:got]).astype(np.complex64)

    @property
    def available(self) -> int:
        return self._lib.rdsp_ring_available(self._h)

    @property
    def dropped(self) -> int:
        return self._lib.rdsp_ring_dropped(self._h)

    @property
    def stats(self) -> dict:
        return {
            "pushed": self._lib.rdsp_ring_pushed(self._h),
            "popped": self._lib.rdsp_ring_popped(self._h),
            "dropped": self._lib.rdsp_ring_dropped(self._h),
            "available": self.available,
        }

    def close(self):
        if self._h:
            self._lib.rdsp_ring_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


class NativeWavReader:
    """Streaming 16-bit WAV capture reader (native chunk walker)."""

    def __init__(self, path: str):
        self._lib = load()
        self._h = self._lib.rdsp_wav_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open WAV: {path}")
        self.sample_rate = self._lib.rdsp_wav_sample_rate(self._h)
        self.channels = self._lib.rdsp_wav_channels(self._h)

    def read_interleaved(self, n_frames: int) -> np.ndarray:
        buf = np.empty(2 * n_frames, np.int16)
        got = self._lib.rdsp_wav_read(self._h, buf.ctypes.data, n_frames)
        return buf[: 2 * got]

    def read_complex(self, n_frames: int) -> np.ndarray:
        inter = self.read_interleaved(n_frames)
        f = inter.astype(np.float32) / 32768.0
        return (f[0::2] + 1j * f[1::2]).astype(np.complex64)

    def close(self):
        if self._h:
            self._lib.rdsp_wav_close(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def q15_to_float_native(q: np.ndarray) -> np.ndarray:
    lib = load()
    q = np.ascontiguousarray(q, np.int16)
    out = np.empty(len(q), np.float32)
    lib.rdsp_q15_to_float(q.ctypes.data, out.ctypes.data, len(q))
    return out


def float_to_q15_native(f: np.ndarray) -> np.ndarray:
    lib = load()
    f = np.ascontiguousarray(f, np.float32)
    out = np.empty(len(f), np.int16)
    lib.rdsp_float_to_q15(f.ctypes.data, out.ctypes.data, len(f))
    return out
