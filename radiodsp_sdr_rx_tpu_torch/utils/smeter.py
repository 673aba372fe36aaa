"""S-meter: signal strength from panadapter bins (``radiodsp_sdr_rx_tpu/utils/smeter.py``).

The reference's meter law (RDSP_display.h:329-374):

  Update_smeter: specVal = sum(FFT.output[75..85]); peak = |specVal / 5|
  displayPeak:   uv    = peak / 10
                 uv    = 0.1*uv + 0.9*uv_old         (1-pole smoothing)
                 dbuv  = 20*log10(uv)
                 s     = 1 + (10 + dbuv*1.2)/6, clamped >= 0
                 s > 9 -> S9+, overflow db = dbuv - 34

as tensor operations over batches of spectrum rows. Every scalar is a
Python float, so a call on a card copies nothing from the host.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

SMETER_BIN_LO = 75
SMETER_BIN_HI = 85  # inclusive (RDSP_display.h:371)
_POLE = 0.9         # uv = 0.1*uv_in + 0.9*uv_old


def smeter_from_spectrum(spectrum: torch.Tensor, uv_old: torch.Tensor):
    """Smoothed micro-volt estimate per spectrum row.

    spectrum: (..., n_updates, 256) display-order panadapter rows; uv_old:
    (...,) the smoothing carry. Returns (uv (..., n_updates), new carry).
    The one-pole smoothing over the rows is the affine scan of
    ``ops/iir.first_order_iir``, its factors Python floats.
    """
    spec_val = spectrum[..., SMETER_BIN_LO:SMETER_BIN_HI + 1].sum(dim=-1)
    uv_in = (spec_val / 5.0).abs() / 10.0
    uv = (1.0 - _POLE) * uv_in
    uv = torch.cat([uv[..., :1] + _POLE * uv_old[..., None], uv[..., 1:]], dim=-1)
    f, sh = _POLE, 1
    while sh < uv.shape[-1]:
        uv = uv + f * F.pad(uv[..., :-sh], (sh, 0))
        f, sh = f * f, 2 * sh
    return uv, uv[..., -1]


def s_units(uv: torch.Tensor):
    """Smoothed uV -> (S-units [0..9], S9-plus dB), as displayPeak."""
    dbuv = 20.0 * torch.log10(uv.clamp(min=1e-12))
    s = (1.0 + (10.0 + dbuv * 1.2) / 6.0).clamp(min=0.0)
    over = s > 9.0
    return torch.where(over, 9.0, s), torch.where(over, dbuv - 34.0, 0.0)
