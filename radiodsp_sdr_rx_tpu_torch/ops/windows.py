"""FIR design windows: a numpy copy of ``radiodsp_sdr_rx_tpu/ops/windows.py``.

The five window families selectable via ``FIR_filter_window`` in the
reference FIR designer (ref: src/RadioDSP_SDR_RX/RDSP_convolutional.h:152-179):

  1 -> 4-term Blackman-Harris (PowerSDR's choice, the app default)
  2 -> alternate 4-term Blackman-Harris (Nuttall coefficient set)
  3 -> cosine
  4 -> Hann
  other -> Blackman-Nuttall

Evaluated in float64 on the host, as the reference computes its coefficients
in ``double``. ``hann_periodic`` and ``blackman_nuttall_periodic`` are the
spectrum analyzers' windows.
"""

from __future__ import annotations

import numpy as np

_BH4 = (0.35875, 0.48829, 0.14128, 0.01168)
_BH4_ALT = (0.355768, 0.487396, 0.144232, 0.012604)
_BLACKMAN_NUTTALL = (0.3635819, 0.4891775, 0.1365995, 0.0106411)


def _cosine_series(n: np.ndarray, num_taps: int, a) -> np.ndarray:
    t = 2.0 * np.pi * n / (num_taps - 1)
    return a[0] - a[1] * np.cos(t) + a[2] * np.cos(2.0 * t) - a[3] * np.cos(3.0 * t)


def fir_window(window_id: int, num_taps: int) -> np.ndarray:
    """Return the length-``num_taps`` design window for reference window id."""
    n = np.arange(num_taps, dtype=np.float64)
    if window_id == 1:
        return _cosine_series(n, num_taps, _BH4)
    if window_id == 2:
        return _cosine_series(n, num_taps, _BH4_ALT)
    if window_id == 3:
        return np.cos(np.pi * n / (num_taps - 1))
    if window_id == 4:
        return 0.5 * (1.0 - np.cos(2.0 * np.pi * n / (num_taps - 1)))
    return _cosine_series(n, num_taps, _BLACKMAN_NUTTALL)


def hann_periodic(n: int) -> np.ndarray:
    """Periodic Hann window of the spectrum analyzers (the Teensy
    ``AudioWindowHanning256`` table, RadioDSP_SDR_RX.ino:144-148)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n, dtype=np.float64) / n)


def blackman_nuttall_periodic(n: int) -> np.ndarray:
    """Periodic Blackman-Nuttall (the analyzer default window, analyze_fft256iq.h)."""
    t = 2.0 * np.pi * np.arange(n, dtype=np.float64) / n
    a = _BLACKMAN_NUTTALL
    return a[0] - a[1] * np.cos(t) + a[2] * np.cos(2.0 * t) - a[3] * np.cos(3.0 * t)
