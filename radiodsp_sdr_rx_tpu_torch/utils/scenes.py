"""Synthetic band scenes — recorded-capture stand-ins for integration tests.

The reference was validated by on-air listening (SURVEY.md §4); this module
synthesizes the equivalent crowded-band RF scenes deterministically so the
BASELINE.json configs are testable offline (no recorded captures can be
shipped): a 40 m evening SSB scene, a 20 m CW pile-up, and a QRM-corrupted SSB
channel for the noise-reduction configs.

All scenes return (iq complex64, dict of ground-truth station parameters).
Frequencies are absolute RF; the capture window is ±fs/2 around ``center``.

A numpy copy of ``radiodsp_sdr_rx_tpu/utils/scenes.py`` (the port imports
nothing of the JAX package); the same seeds give the same arrays bit for
bit. ``golden_cases`` adds the receiver configurations of the committed
golden fixtures (``tools/make_goldens.build_cases``), so that the port can
rebuild them without the JAX package.
"""

from __future__ import annotations

import numpy as np

from radiodsp_sdr_rx_tpu_torch.utils import siggen

FS = 44117.64706


def band_scene_40m_ssb(
    n: int,
    center: float = 7_150_000.0,
    fs: float = FS,
    seed: int = 40,
) -> tuple[np.ndarray, dict]:
    """Evening 40 m phone band: three LSB stations + a carrier + band noise.

    (40 m phone is conventionally LSB.) Stations sit at distinct offsets with
    distinct syllabic rates so tests can verify isolation.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    stations = {
        "s1": dict(freq=center - 12_000.0, amp=0.30, tones=(500.0, 1100.0, 1700.0), syl=2.3),
        "s2": dict(freq=center + 5_000.0, amp=0.22, tones=(420.0, 900.0, 2100.0), syl=3.7),
        "s3": dict(freq=center + 15_000.0, amp=0.15, tones=(650.0, 1300.0, 1900.0), syl=1.6),
    }
    iq = np.zeros(n, np.complex64)
    for name, st in stations.items():
        audio = sum(
            g * np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi))
            for f, g in zip(st["tones"], (1.0, 0.6, 0.35))
        )
        audio *= 0.55 + 0.45 * np.sin(2 * np.pi * st["syl"] * t)
        audio /= np.abs(audio).max()
        st["audio"] = audio
        iq = iq + siggen.ssb_from_audio(audio, st["freq"] - center, fs, "lsb",
                                        amp=st["amp"])
    # steady birdie carrier + band noise
    iq = iq + siggen.carrier(n, -8_000.0, fs, amp=0.05)
    iq = (iq + siggen.noise(n, 0.01, seed=seed)).astype(np.complex64)
    return iq, {"center": center, "stations": stations}


def band_scene_20m_cw(
    n: int,
    center: float = 14_050_000.0,
    fs: float = FS,
    seed: int = 20,
    wpm: float = 25.0,
) -> tuple[np.ndarray, dict]:
    """20 m CW pile-up: four keyed carriers at distinct offsets + noise.

    Keying is hard on/off at pseudo-random Morse-ish element timing; ground
    truth includes each station's on/off envelope for detection tests.
    """
    rng = np.random.default_rng(seed)
    dit = 1.2 / wpm
    stations = {
        "c1": dict(freq=center + 2_000.0, amp=0.30),
        "c2": dict(freq=center - 4_500.0, amp=0.22),
        "c3": dict(freq=center + 9_000.0, amp=0.15),
        "c4": dict(freq=center - 11_000.0, amp=0.10),
    }
    iq = np.zeros(n, np.complex64)
    for name, st in stations.items():
        # pseudo-Morse: random run lengths of 1-3 dits on, 1-3 dits off
        env = np.zeros(n, np.float32)
        pos = 0
        on = True
        # stable across processes (Python's hash() is randomized per run,
        # which silently made this scene non-deterministic)
        import zlib

        r = np.random.default_rng(zlib.crc32(name.encode()) % (2**31))
        while pos < n:
            run = int(r.integers(1, 4) * dit * fs)
            if on:
                env[pos : pos + run] = 1.0
            pos += run
            on = not on
        # 5 ms raised-cosine keying edges to bound key clicks
        edge = max(int(0.005 * fs), 1)
        kernel = 0.5 - 0.5 * np.cos(np.pi * np.arange(1, edge + 1) / edge)
        env = np.convolve(env, kernel / kernel.sum(), mode="same")
        st["envelope"] = env
        iq = iq + st["amp"] * env * siggen.carrier(n, st["freq"] - center, fs, 1.0)
    iq = (iq + siggen.noise(n, 0.008, seed=seed)).astype(np.complex64)
    return iq, {"center": center, "stations": stations, "dit_s": dit}


def qrm_ssb_scene(
    n: int,
    center: float = 7_150_000.0,
    fs: float = FS,
    seed: int = 7,
) -> tuple[np.ndarray, dict]:
    """QRM-corrupted SSB channel (BASELINE config 4): desired USB voice at
    +10 kHz with an interfering carrier inside the passband, impulse bursts,
    and elevated band noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    # speech-like NON-stationary audio: band-limited noise with syllabic AM.
    # (Steady sinusoids would be indistinguishable from heterodynes to the
    # auto-notch — real speech is unpredictable across the LMS delay.)
    white = rng.standard_normal(n)
    spec = np.fft.rfft(white)
    f_axis = np.fft.rfftfreq(n, 1 / fs)
    spec[(f_axis < 300) | (f_axis > 2800)] = 0
    audio = np.fft.irfft(spec, n)
    audio *= 0.55 + 0.45 * np.sin(2 * np.pi * 2.7 * t)
    audio /= np.abs(audio).max()
    f0 = center + 10_000.0
    iq = siggen.ssb_from_audio(audio, 10_000.0, fs, "usb", amp=0.35)
    # in-passband heterodyne (auto-notch target): 2.2 kHz above the suppressed
    # carrier, clear of the voice formant tones
    iq = iq + siggen.carrier(n, 10_000.0 + 2_200.0, fs, amp=0.08)
    # impulse noise bursts (noise-blanker target)
    n_imp = n // 8000
    idx = rng.integers(0, n, n_imp)
    imp = np.zeros(n, np.complex64)
    imp[idx] = (rng.standard_normal(n_imp) + 1j * rng.standard_normal(n_imp)) * 3.0
    iq = iq + imp
    iq = (iq + siggen.noise(n, 0.04, seed=seed + 1)).astype(np.complex64)
    return iq, {"center": center, "station_freq": f0, "audio": audio,
                "het_offset_hz": 2_200.0}


def voiced_qrm_scene(
    n: int,
    center: float = 7_150_000.0,
    fs: float = FS,
    seed: int = 3,
) -> tuple[np.ndarray, dict]:
    """Voiced USB speech in steady band noise (round 4 / VERDICT r3 #5): the
    golden scene on which spectral-subtraction NR must demonstrably IMPROVE
    the demodulated SNR (the backup engine's purpose,
    src/backup/RDSP_convolutional_spec.h:194-238). Harmonic speech with
    pauses (siggen.voiced_speech) + elevated white band noise + weak
    adjacent-channel splatter."""
    rng = np.random.default_rng(seed)
    audio = siggen.voiced_speech(n, fs, seed=seed)
    f0 = center + 10_000.0
    iq = siggen.ssb_from_audio(audio, 10_000.0, fs, "usb", amp=0.5)
    # weak adjacent-channel splatter 4 kHz up (mostly filtered out)
    adj = siggen.voice_like(n, fs, seed=seed + 9)
    iq = iq + siggen.ssb_from_audio(adj, 14_000.0, fs, "usb", amp=0.08)
    iq = (iq + siggen.noise(n, 0.10, seed=seed + 1)).astype(np.complex64)
    return iq, {"center": center, "station_freq": f0, "audio": audio}


def fading_ssb_scene(
    n: int,
    center: float = 7_150_000.0,
    fs: float = FS,
    seed: int = 5,
    doppler_hz: float = 1.0,
    delay_s: float = 0.001,
) -> tuple[np.ndarray, dict]:
    """Ionospheric-channel SSB scene (round 5, VERDICT r4 #9): a USB voice
    station through a two-path Watterson-style HF channel — each path a
    complex Rayleigh fading process (Gaussian-filtered at ``doppler_hz``
    spread), the second path ~1 ms delayed with an independent Doppler — in
    impulsive atmospheric noise (Gaussian floor + Poisson static crashes,
    the noise-blanker target) plus the usual band noise.

    Returns (iq, truth) with the clean audio, the dominant-path magnitude
    ``fade_env`` (for envelope-tracking metrics — an aligned static-gain SNR
    fit cannot follow fading), and the impulse sample positions.
    """
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    audio = siggen.voiced_speech(n, fs, seed=seed)
    f0 = center + 10_000.0
    clean = siggen.ssb_from_audio(audio, 10_000.0, fs, "usb", amp=0.5)

    def rayleigh(seed_k):
        """Unit-mean-square complex fading process, ``doppler_hz`` spread."""
        g = (rng.standard_normal(n) + 1j * rng.standard_normal(n))
        spec = np.fft.fft(g)
        f_axis = np.fft.fftfreq(n, 1 / fs)
        spec[np.abs(f_axis) > doppler_hz] = 0
        h = np.fft.ifft(spec)
        h /= np.sqrt(np.mean(np.abs(h) ** 2) + 1e-30)
        return h.astype(np.complex64)

    h1 = rayleigh(0)
    h2 = rayleigh(1)
    d = max(1, int(round(delay_s * fs)))
    path2 = np.concatenate([np.zeros(d, np.complex64), clean[:-d]])
    iq = clean * h1 * 0.85 + path2 * h2 * 0.4

    # atmospheric static crashes: Poisson impulses, heavy amplitudes
    n_imp = max(4, n // 6000)
    idx = rng.integers(2000, n - 1, n_imp)
    imp = np.zeros(n, np.complex64)
    imp[idx] = ((rng.standard_normal(n_imp) + 1j * rng.standard_normal(n_imp))
                * rng.pareto(2.0, n_imp).clip(0.5, 8.0) * 2.0)
    iq = iq + imp
    iq = (iq + siggen.noise(n, 0.015, seed=seed + 1)).astype(np.complex64)
    return iq, {"center": center, "station_freq": f0, "audio": audio,
                "fade_env": np.abs(h1).astype(np.float32),
                "impulse_idx": idx}


def golden_cases(n: int = 1 << 16):
    """The six golden scenes of tests/goldens/*.npz -> [(name, config, iq,
    truth)], the configurations of ``tools/make_goldens.build_cases`` (AGC
    off; LSB, CW narrow, USB with SPEC2, NOTCH, SPEC2 and the blanker)."""
    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, DemodMode, NRMode, ReceiverConfig)

    iq40, truth40 = band_scene_40m_ssb(n)
    iqcw, truthcw = band_scene_20m_cw(n)
    iqq, truthq = qrm_ssb_scene(n)
    iqv, truthv = voiced_qrm_scene(n)
    iqf, truthf = fading_ssb_scene(n)
    cases = [
        ("ssb40m_s2", DemodMode.LSB, truth40["stations"]["s2"]["freq"], truth40, iq40, {}),
        ("cw20m_c1", DemodMode.CW_NARROW, truthcw["stations"]["c1"]["freq"], truthcw, iqcw, {}),
        ("qrm_usb_spec2", DemodMode.USB, truthq["station_freq"], truthq, iqq,
         {"nr": NRMode.SPEC2}),
        ("qrm_usb_notch", DemodMode.USB, truthq["station_freq"], truthq, iqq,
         {"nr": NRMode.NOTCH}),
        ("voiced_usb_spec2", DemodMode.USB, truthv["station_freq"], truthv, iqv,
         {"nr": NRMode.SPEC2}),
        ("fading_usb_nb", DemodMode.USB, truthf["station_freq"], truthf, iqf,
         {"noise_blanker": True}),
    ]
    return [(name, ReceiverConfig(mode=mode, vfo_freq=freq, capture_center_freq=truth["center"],
                                  agc=AGCMode.OFF, **extra), iq, truth)
            for name, mode, freq, truth, iq, extra in cases]
