"""Scope and waterfall quantities as tensors, and the host ASCII renderers
(``radiodsp_sdr_rx_tpu/utils/display.py``).

The reference paints an ILI9341 TFT (RDSP_display.h); the outputs of that
pipeline, the smoothed spectrum bars and the scrolling waterfall with its
7-level colour classes, are tensors here, and the renderers, numpy on the
host, take them as numpy arrays or CPU tensors (``.cpu()`` a card's).

- 5-point frequency smoothing, weights x:0.7, x+-1:0.3, x+-2:0.15 for
  2 <= x < 254, pass-through at the edges (RDSP_display.h:260-271)
- time smoothing view = 0.7 * 2*sqrt(|avg|*5) + 0.3 * view_old (:276)
- waterfall rows scroll down, row 0 = |view[2x]| per column (:284, :294-297)
- colour thresholds (low=0): >=75 red, >=50 magenta, >=40 orange, >=25
  yellow, >=15 blue, >=5 navy, else black (:299-318)

Every scalar of the tensor functions is a Python number, so a call on a card
copies nothing from the host.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_WATERFALL = 50      # rows (RDSP_general_includes.h:118)
LPF_COEFF = 0.7         # time-smoothing (RDSP_display.h:242)
FREQ_WEIGHTS = (0.7, 0.3, 0.15)  # x, x+-1, x+-2 (RDSP_display.h:266-268)
SCALE = 5               # amplitude scale (RDSP_display.h:240)

# threshold -> colour name, descending (RDSP_display.h:299-318)
WATERFALL_THRESHOLDS = (75, 50, 40, 25, 15, 5)
WATERFALL_COLORS = ("red", "magenta", "orange", "yellow", "blue", "navy", "black")


def spectrum_bars(spectrum: torch.Tensor) -> torch.Tensor:
    """The frequency-smoothed bars before the time smoothing, 0.7 * 2 *
    sqrt(|avg| * 5), of rows (..., 256): the part of ``spectrum_smooth``
    that does not depend on the carry, for any number of rows at once."""
    w0, w1, w2 = FREQ_WEIGHTS
    s = spectrum
    avg = (s * w0
           + torch.roll(s, 1, dims=-1) * w1
           + torch.roll(s, -1, dims=-1) * w1
           + torch.roll(s, 2, dims=-1) * w2
           + torch.roll(s, -2, dims=-1) * w2)
    idx = torch.arange(s.shape[-1], device=s.device)
    interior = (idx > 1) & (idx < s.shape[-1] - 2)
    avg = torch.where(interior, avg, s)
    return LPF_COEFF * 2.0 * torch.sqrt(avg.abs() * SCALE)


def spectrum_smooth(spectrum: torch.Tensor, view_old: torch.Tensor):
    """Frequency + time smoothing of one panadapter row.

    spectrum: (..., 256) raw analyzer output (display order); view_old:
    (..., 256) the previous smoothed view. Returns (view, view): the new
    view is also the next carry.
    """
    view = spectrum_bars(spectrum) + (1.0 - LPF_COEFF) * view_old
    return view, view


def waterfall_update(history: torch.Tensor, view: torch.Tensor, n_cols: int = 128):
    """Scroll the waterfall down one row; new row 0 = |view[2x]| per column.

    history: (..., MAX_WATERFALL, n_cols); view: (..., 256).
    """
    row = view[..., :2 * n_cols:2].abs()
    return torch.cat([row[..., None, :], history[..., :-1, :]], dim=-2)


def classify_waterfall_colors(history: torch.Tensor) -> torch.Tensor:
    """Colour-class indices 0..6 (into WATERFALL_COLORS) per cell, int32."""
    n = len(WATERFALL_THRESHOLDS)
    cls = torch.full(history.shape, n, dtype=torch.int32, device=history.device)  # black
    for i, th in enumerate(reversed(WATERFALL_THRESHOLDS)):
        cls = torch.where(history >= th, n - 1 - i, cls)
    return cls


_ASCII = " .:-=+*#@"


def render_waterfall_ascii(history: np.ndarray, width: int = 128) -> str:
    """Host-side renderer: the ILI9341 stand-in for terminals."""
    h = np.asarray(history)[..., :width]
    lo, hi = 0.0, max(80.0, float(h.max()) or 1.0)
    idx = np.clip((h - lo) / (hi - lo) * (len(_ASCII) - 1), 0, len(_ASCII) - 1).astype(int)
    return "\n".join("".join(_ASCII[c] for c in row) for row in idx)


def render_spectrum_ascii(view: np.ndarray, width: int = 128, height: int = 16) -> str:
    """Bar-scope renderer (the reference's green bar spectrum, clip at 80)."""
    bars = np.clip(np.abs(np.asarray(view)[: 2 * width : 2]), 0, 80)
    levels = (bars / 80.0 * height).astype(int)
    rows = []
    for r in range(height, 0, -1):
        rows.append("".join("|" if l >= r else " " for l in levels))
    return "\n".join(rows)


def render_audio_spectrum_ascii(audio_bins: np.ndarray, height: int = 14) -> str:
    """AF-FFT scope: 101 audio-FFT bins, bar = |bin|*5 clipped at 70
    (Update_AudioSpectrum, RDSP_display.h:210-230)."""
    bars = np.clip(np.abs(np.asarray(audio_bins)[:101]) * SCALE, 0, 70)
    levels = (bars / 70.0 * height).astype(int)
    rows = []
    for r in range(height, 0, -1):
        rows.append("".join("|" if l >= r else " " for l in levels))
    return "\n".join(rows)


def render_status_ascii(config, vfo=None, s_units: float | None = None,
                        menu_level: int | None = None) -> str:
    """Status-field header: frequency with the step-digit tuning cursor,
    mode / filter / NR / AGC / step fields and the S-meter readout — the
    ASCII stand-in for the reference's TFT text fields (showFreq
    RDSP_controls.h:453-564; showMode/showFilter/showNR/showAGC/showStep
    RDSP_display.h:74-190; S-meter text :329-364).

    config: ReceiverConfig; vfo: VFO (step cursor; frequency falls back to
    config.vfo_freq without it); s_units: displayPeak's S-value (9.0 == S9,
    +10 dB over S9 -> 10.0 etc.); menu_level: highlight the active menu row
    (RDSP_display.h menu-level marker).
    """
    freq = int(vfo.freq) if vfo is not None else int(config.vfo_freq)
    # grouped digits, fixed 8-wide like the reference's 30 MHz ceiling
    ftxt = f"{freq:>8d}"
    grouped = ""
    for i, ch in enumerate(ftxt):
        grouped += ch
        if (len(ftxt) - 1 - i) in (3, 6) and ch != " ":
            grouped += "."
    # red tuning cursor under the step digit (showFreq's cursor line,
    # RDSP_controls.h:487-560): mark the digit the current step changes
    cursor = " " * len(grouped)
    if vfo is not None:
        import math
        digit = int(math.log10(vfo.step))         # 0 (1 Hz) .. 6 (1 MHz)
        dots = sum(1 for j in (3, 6) if digit >= j)  # group dots right of it
        gpos = len(grouped) - 1 - (digit + dots)
        cursor = " " * gpos + "^" + " " * (len(grouped) - gpos - 1)
    flt = config.effective_audio_filter
    nr = config.nr.name if hasattr(config.nr, "name") else str(config.nr)
    fields = [
        f"{grouped} Hz",
        f"[{config.mode.value}]",
        f"FLT {flt.lo:.0f}-{flt.hi:.0f}",
        f"NR:{nr}",
        f"AGC:{config.agc.value.upper()}",
    ]
    if vfo is not None:
        step = vfo.step
        if step >= 1_000_000:
            stxt = f"{step // 1_000_000}M"
        elif step >= 1000:
            stxt = f"{step // 1000}k"
        else:
            stxt = str(step)
        fields.append(f"STEP {stxt}")
    if s_units is not None:
        if s_units <= 9.0:
            fields.append(f"S{min(9, max(0, int(round(s_units))))}")
        else:
            fields.append(f"S9+{int(round(s_units - 9.0))}")
    if menu_level is not None:
        fields.append(f"MENU L{menu_level}")
    line = "  ".join(fields)
    return line + "\n" + cursor


def render_spectrum_cursor(width: int = 128) -> str:
    """The panadapter's red tuning-cursor column (Update_Panadapter's
    vertical lines at the display center, RDSP_display.h:322-323): the tuned
    frequency sits at the center bin of the +-22 kHz span."""
    c = width // 2
    return " " * (c - 1) + "│" + " " * (width - c)


def render_double_spectrum_ascii(
    view: np.ndarray, audio_bins: np.ndarray, height: int = 14
) -> str:
    """Combined dual-scope layout (Update_DoubleSpectrum,
    RDSP_display.h:380-401): half-width RX panadapter on the left, AF-FFT
    audio scope on the right, separated like the reference's cyan divider.

    view: (256,) smoothed panadapter view (models/metrics 'view');
    audio_bins: (>=101,) audio-FFT magnitudes (one 'audio_spectrum' row).
    """
    left = render_spectrum_ascii(view, width=64, height=height).splitlines()
    right = render_audio_spectrum_ascii(audio_bins, height=height).splitlines()
    header = "RX-SCOPE".ljust(64) + " | " + "AF-FFT"
    body = [f"{l} | {r}" for l, r in zip(left, right)]
    rule = "-" * 64 + " + " + "-" * 101
    return "\n".join([header, rule] + body)
