"""Observability: the reference's visual outputs as tensors (``radiodsp_sdr_rx_tpu/models/metrics.py``).

The reference's only observability is its TFT display: S-meter, panadapter
spectrum and waterfall, audio-FFT scope. ``analyze`` computes those
quantities for one segment, beside the audio path:

  - panadapter: 500 Hz high-pass biquads on I and Q (ino:155-156, a
    log-depth scan, ``ops/iir.biquad_apply``) -> 256-point IQ spectrum with
    a Hann window and 30-frame averaging -> display-order rows
  - smoothed scope view, scrolling waterfall and colour classes
  - S-meter from bins 75-85 with the reference's uV / dBuV / S-unit law
  - audio scope: 1024-point FFT, 30-frame averaging (ino:147-148)

``analyze`` runs on the device of its inputs and returns tensors there; it
reads nothing back to the host and copies nothing to the card after its
first call on a device (``ops/analyzers._on_device``), so the audio path
never waits for the scope. The JAX package jits it as ``analyze_jit``; here
``analyze_jit`` is the same callable, run eagerly.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radiodsp_sdr_rx_tpu_torch.ops import analyzers
from radiodsp_sdr_rx_tpu_torch.ops.iir import biquad_apply, biquad_highpass
from radiodsp_sdr_rx_tpu_torch.utils import display as disp
from radiodsp_sdr_rx_tpu_torch.utils import smeter as smeter_mod
from radiodsp_sdr_rx_tpu_torch.utils.convert import resolve_device


class ScopeState(NamedTuple):
    """Carried display state, field for field the JAX ``ScopeState``."""

    biquad_i: torch.Tensor   # (2,) panadapter pre-filter state, I channel
    biquad_q: torch.Tensor   # (2,) Q channel
    view_old: torch.Tensor   # (256,) smoothed spectrum carry
    waterfall: torch.Tensor  # (MAX_WATERFALL, 128) scrolling history
    uv_old: torch.Tensor     # () S-meter smoothing carry
    iq_tail: torch.Tensor    # (128,) complex64 analyzer prevblock carry (IQ spectrum)
    audio_tail: torch.Tensor  # (512,) analyzer prevblock carry (audio scope)


def scope_init(device=None) -> ScopeState:
    """A fresh scope state on ``device`` (None: the card)."""
    dev = resolve_device(device)
    return ScopeState(
        biquad_i=torch.zeros(2, device=dev),
        biquad_q=torch.zeros(2, device=dev),
        view_old=torch.zeros(256, device=dev),
        waterfall=torch.zeros(disp.MAX_WATERFALL, 128, device=dev),
        uv_old=torch.zeros((), device=dev),
        iq_tail=torch.zeros(128, dtype=torch.complex64, device=dev),
        audio_tail=torch.zeros(512, device=dev),
    )


def analyze(iq, audio, state: ScopeState, naverage: int = 30,
            sample_rate: float = 44117.64706, audio_naverage: int | None = None):
    """Every display metric of one segment.

    iq: (n,) complex64, the raw capture segment (pre-NCO, like the
    reference's panadapter tap off the I2S input, ino:75-78), n a multiple
    of 128; audio: (m,) f32 demodulated audio for the audio scope, m a
    multiple of 512. Tensors on the state's device (numpy is copied there).
    Returns (metrics, new state), the metrics:
      spectrum       (u, 256)  raw analyzer rows, display bin order
      view           (256,)    smoothed scope bars after the last update
      waterfall      (50, 128) scrolled history
      waterfall_cls  (50, 128) int32 colour classes into WATERFALL_COLORS
      smeter_uv      (u,)      smoothed uV track
      s_units, s9_plus_db      () the final S-meter reading
      audio_spectrum (ua, 512) audio scope rows
    ``audio_naverage`` (default ``naverage``) lets callers with short
    blocks (the appliance's 4,096 samples) still get an audio row a block.
    """
    dev = state.view_old.device
    iq = torch.as_tensor(iq, device=dev)
    audio = torch.as_tensor(audio, dtype=torch.float32, device=dev)
    coeffs = biquad_highpass(500.0, sample_rate, 0.5)
    # I and Q through one batched scan: half the launches of two
    y, bq = biquad_apply(torch.stack([iq.real, iq.imag]).float(), coeffs,
                         torch.stack([state.biquad_i, state.biquad_q]))
    iq_f = torch.complex(y[0], y[1])
    bq_i, bq_q = bq[0], bq[1]

    spectrum = analyzers.iq_spectrum_frames(iq_f, naverage=naverage, tail=state.iq_tail)

    # the rows through the time smoothing (a recurrence over the rows) and
    # the waterfall's scroll, newest row on top, as the JAX scan folds them
    bars = disp.spectrum_bars(spectrum)
    view, views = state.view_old, []
    for row in bars:
        view = row + (1.0 - disp.LPF_COEFF) * view
        views.append(view)
    waterfall = state.waterfall
    if views:
        rows = torch.stack(views[::-1])[:, :2 * waterfall.shape[-1]:2].abs()
        waterfall = torch.cat([rows, waterfall], dim=0)[:waterfall.shape[0]]

    uv, uv_old = smeter_mod.smeter_from_spectrum(spectrum, state.uv_old)
    s, plus_db = smeter_mod.s_units(uv[..., -1])

    audio_spectrum = analyzers.audio_spectrum_frames(
        audio, naverage=naverage if audio_naverage is None else audio_naverage,
        tail=state.audio_tail)

    metrics = {
        "spectrum": spectrum,
        "view": view,
        "waterfall": waterfall,
        "waterfall_cls": disp.classify_waterfall_colors(waterfall),
        "smeter_uv": uv,
        "s_units": s,
        "s9_plus_db": plus_db,
        "audio_spectrum": audio_spectrum,
    }
    new_state = ScopeState(
        biquad_i=bq_i, biquad_q=bq_q, view_old=view, waterfall=waterfall,
        uv_old=uv_old, iq_tail=iq_f[..., -128:], audio_tail=audio[..., -512:],
    )
    return metrics, new_state


# the JAX package's jitted entry (models/streaming.py imports the name)
analyze_jit = analyze
