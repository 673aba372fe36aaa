"""Synthetic IQ signal generators for tests and benchmarks.

A numpy copy of ``radiodsp_sdr_rx_tpu/utils/siggen.py`` (the port imports
nothing of the JAX package); the same seeds give the same arrays bit for bit.

Stand-ins for the reference's antenna + QSD front end: the reference has no
test fixtures at all (SURVEY.md §4), so these generators — carrier, AM,
SSB-from-audio, two-tone, noise — are the oracle inputs for the test pyramid
and for BASELINE.json configs 1-4.
"""

from __future__ import annotations

import numpy as np

DEFAULT_FS = 44117.64706


def carrier(n: int, freq_hz: float, fs: float = DEFAULT_FS, amp: float = 0.5,
            phase: float = 0.0) -> np.ndarray:
    """Complex exponential at ``freq_hz`` (positive = above center)."""
    t = np.arange(n, dtype=np.float64) / fs
    return (amp * np.exp(1j * (2 * np.pi * freq_hz * t + phase))).astype(np.complex64)


def two_tone(n: int, f1: float, f2: float, fs: float = DEFAULT_FS,
             amp: float = 0.25) -> np.ndarray:
    return (carrier(n, f1, fs, amp) + carrier(n, f2, fs, amp)).astype(np.complex64)


def am_signal(n: int, carrier_hz: float, mod_hz: float = 1000.0,
              depth: float = 0.5, fs: float = DEFAULT_FS,
              amp: float = 0.5) -> np.ndarray:
    """AM: carrier at ``carrier_hz`` modulated by a ``mod_hz`` tone."""
    t = np.arange(n, dtype=np.float64) / fs
    env = 1.0 + depth * np.cos(2 * np.pi * mod_hz * t)
    return (amp * env * np.exp(2j * np.pi * carrier_hz * t)).astype(np.complex64)


def ssb_from_audio(audio: np.ndarray, offset_hz: float, fs: float = DEFAULT_FS,
                   sideband: str = "usb", amp: float = 0.5) -> np.ndarray:
    """Synthesize an SSB IQ signal from a real audio waveform.

    The analytic signal of ``audio`` (FFT positive-frequency mask) is shifted to
    ``offset_hz``; LSB conjugates first so the audio spectrum appears below the
    (suppressed) carrier.
    """
    n = len(audio)
    spec = np.fft.fft(audio.astype(np.float64))
    mask = np.zeros(n)
    mask[0] = 1.0
    mask[1 : n // 2] = 2.0
    if n % 2 == 0:
        mask[n // 2] = 1.0
    analytic = np.fft.ifft(spec * mask)
    if sideband == "lsb":
        analytic = np.conj(analytic)
    t = np.arange(n, dtype=np.float64) / fs
    return (amp * analytic * np.exp(2j * np.pi * offset_hz * t)).astype(np.complex64)


def voice_like(n: int, fs: float = DEFAULT_FS, seed: int = 0) -> np.ndarray:
    """A speech-band multitone (formant-ish) test waveform, peak-normalized."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / fs
    tones = [(430.0, 1.0), (700.0, 0.7), (1210.0, 0.5), (1900.0, 0.3), (2500.0, 0.2)]
    a = sum(g * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) for f, g in tones)
    # slow syllabic amplitude modulation
    a *= 0.6 + 0.4 * np.sin(2 * np.pi * 3.1 * t)
    return (a / np.max(np.abs(a))).astype(np.float64)


def noise(n: int, level: float = 0.05, seed: int = 1, complex_: bool = True):
    rng = np.random.default_rng(seed)
    if complex_:
        return (level / np.sqrt(2) * (rng.standard_normal(n) + 1j * rng.standard_normal(n))).astype(np.complex64)
    return (level * rng.standard_normal(n)).astype(np.float32)


def voiced_speech(n: int, fs: float = DEFAULT_FS, seed: int = 0,
                  f0_hz: float = 118.0) -> np.ndarray:
    """Voiced-speech synthesis for NR-effectiveness goldens (round 4).

    Unlike ``voice_like`` (stationary multitone) and the QRM scene's
    band-limited noise, this is HARMONIC: a glottal-style pulse train —
    a pitch-drifting harmonic stack shaped by a formant envelope
    (F1/F2/F3 ~ 550/1450/2500 Hz) — gated by syllables with real PAUSES.
    The pauses let a VAD-style noise-floor tracker (the backup engine's
    spectral subtraction, RDSP_convolutional_spec.h:194-206) lock onto the
    channel noise, and the harmonic structure concentrates speech energy in
    narrow bins the subtractor keeps — so NR can demonstrably IMPROVE SNR
    on this signal, which band-limited noise "speech" cannot show.
    Peak-normalized float64.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64) / fs
    # slowly drifting pitch (vibrato + wander)
    f0 = f0_hz * (1.0 + 0.03 * np.sin(2 * np.pi * 4.7 * t)
                  + 0.05 * np.sin(2 * np.pi * 0.37 * t + 1.1))
    phase0 = 2.0 * np.pi * np.cumsum(f0) / fs

    def formant_env(f):
        e = np.zeros_like(f)
        for fc, bw, g in ((550.0, 90.0, 1.0), (1450.0, 140.0, 0.63),
                          (2500.0, 220.0, 0.35)):
            e = e + g / (1.0 + ((f - fc) / bw) ** 2)
        return e * (f > 180.0) * (f < 2900.0)

    a = np.zeros(n)
    kmax = int(2900.0 / f0_hz) + 1
    for k in range(1, kmax):
        amp = formant_env(np.full(1, k * f0_hz))[0]
        if amp <= 0.0:
            continue
        a += amp * np.sin(k * phase0 + rng.uniform(0, 2 * np.pi))

    # syllable gating with real pauses (~45% duty) and 10 ms edges
    syll = np.zeros(n)
    pos = 0
    while pos < n:
        on = int(rng.uniform(0.12, 0.35) * fs)
        off = int(rng.uniform(0.10, 0.30) * fs)
        syll[pos:pos + on] = 1.0
        pos += on + off
    edge = int(0.010 * fs)
    kern = np.hanning(2 * edge + 1)
    syll = np.convolve(syll, kern / kern.sum(), mode="same")
    a *= syll * (0.7 + 0.3 * np.sin(2 * np.pi * 2.3 * t + 0.5))
    return a / max(np.abs(a).max(), 1e-12)
