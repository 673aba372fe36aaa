"""Entry: one of the port's fused banks (``models/fused``), built from a
configuration file's settings.

``make(settings, device)`` returns the bank; the window calls its
``init_state()`` and ``process_planar(xr, xi, state)``. ``state_view``
gives every tensor of the threaded state under its field's name, cut to
the bank's channels: a field's leading axis is the channel's, and the
lanes past them are padding, the program's own. The configuration's
``compare`` says which of them the comparison reads.
"""

from __future__ import annotations

import torch


def make(settings: dict, device):
    from radiodsp_sdr_rx_tpu_torch.models import fused
    from radiodsp_sdr_rx_tpu_torch.models.config import (
        AGCMode, AudioFilter, DemodMode, FilterWindow, NRMode, ReceiverConfig)

    s = settings
    config = ReceiverConfig(
        mode=DemodMode[s["mode"]], vfo_freq=float(s["vfo_hz"]),
        capture_center_freq=float(s["capture_center_hz"]), agc=AGCMode(s["agc"]),
        nr=NRMode[s.get("nr_mode", "OFF")], audio_filter=AudioFilter(tuple(s["audio_filter_hz"])),
        pbt_lo=float(s["pbt_hz"][0]), pbt_hi=float(s["pbt_hz"][1]),
        fir_window=FilterWindow(int(s["fir_window"])), sample_rate=float(s["sample_rate"]),
        fft_length=int(s["fft_length"]), agc_release_s=float(s["agc_release_s"]),
        agc_target=float(s["agc_target"]), agc_max_gain=float(s["agc_max_gain"]),
        input_gain=float(s["input_gain"]), output_gain=float(s["output_gain"]),
        iq_gain_balance=float(s["iq_gain_balance"]))
    freqs = [float(s["first_channel_hz"]) + float(s["channel_spacing_hz"]) * k
             for k in range(int(s["channels"]))]
    args = dict(s["entry_args"])
    bank = getattr(fused, args.pop("bank"))
    return bank(config, freqs, device=device, **args)


def state_view(bank, state) -> dict:
    c = bank.n_channels
    return {k: v[:c] if v.dim() else v for k, v in state._asdict().items() if torch.is_tensor(v)}
