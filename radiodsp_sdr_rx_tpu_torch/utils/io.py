"""IQ capture / audio file I/O: the port's own copy of ``radiodsp_sdr_rx_tpu/utils/io.py``.

Replaces the reference's I2S codec boundary (SGTL5000 stereo in/out,
ref: RadioDSP_SDR_RX.ino:52-60, 159-169): IQ enters from stereo WAV captures
(L=I, R=Q, the standard SDR recording convention) or raw interleaved files,
and demodulated audio leaves as WAV. numpy in and out, on the host: callers
move the arrays to the card. The native ring (``utils/native_io.py``) is the
streaming path; this module is the offline file path.
"""

from __future__ import annotations

import struct
import wave

import numpy as np


def read_iq_wav(path: str) -> tuple[np.ndarray, float]:
    """Read a stereo WAV as complex64 IQ (L + jQ). Returns (iq, sample_rate)."""
    with wave.open(path, "rb") as w:
        nch = w.getnchannels()
        width = w.getsampwidth()
        fs = float(w.getframerate())
        raw = w.readframes(w.getnframes())
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width {width}")
    if nch == 2:
        data = data.reshape(-1, 2)
        iq = (data[:, 0] + 1j * data[:, 1]).astype(np.complex64)
    elif nch == 1:
        iq = data.astype(np.complex64)
    else:
        raise ValueError(f"unsupported channel count {nch}")
    return iq, fs


def write_wav(path: str, audio: np.ndarray, sample_rate: float) -> None:
    """Write mono or stereo float audio as 16-bit WAV (q15 quantization — the
    same arm_float_to_q15 boundary the reference's I2S output applies)."""
    a = np.asarray(audio)
    if a.ndim == 1:
        a = a[:, None]
    q = np.clip(np.trunc(a * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(a.shape[1])
        w.setsampwidth(2)
        w.setframerate(int(round(sample_rate)))
        w.writeframes(q.tobytes())


def read_raw_iq(path: str, dtype: str = "i2") -> np.ndarray:
    """Read raw interleaved I/Q (cs16 'i2', cu8 'u1', cf32 'f4') as complex64."""
    raw = np.fromfile(path, dtype=np.dtype("<" + dtype))
    if dtype == "u1":
        raw = (raw.astype(np.float32) - 127.5) / 127.5
    elif dtype == "i2":
        raw = raw.astype(np.float32) / 32768.0
    raw = raw.astype(np.float32).reshape(-1, 2)
    return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)


def write_raw_iq(path: str, iq: np.ndarray) -> None:
    """Write complex64 IQ as raw interleaved cs16."""
    a = np.asarray(iq)
    out = np.empty((len(a), 2), dtype="<i2")
    out[:, 0] = np.clip(np.trunc(a.real * 32768.0), -32768, 32767)
    out[:, 1] = np.clip(np.trunc(a.imag * 32768.0), -32768, 32767)
    out.tofile(path)
