"""IQ pre-processor: gain balance and I2S-slip detection and repair (``radiodsp_sdr_rx_tpu/ops/preprocessor.py``).

The reference's ``AudioSDRpreProcessor`` (RadioDSP_SDR_RX.ino:117-118, 135):
the stereo I2S link can come up with I and Q slipped by one sample, which
destroys image rejection. The repairs are candidate streams (identity, swap,
I delayed one sample, Q delayed one sample); the detector scores each by the
spectral asymmetry |E+ - E-| / (E+ + E-) of its spectrum, which a correctly
aligned capture of a real band maximises, and picks the best.

``detect_iq_error`` and ``repair_iq`` work on complex tensors (all four
candidates, the index a 0-d tensor). ``detect_iq_error_host`` and
``apply_repair_planar_host`` are what ``models/receiver.Receiver`` runs on
every segment, on planar f32 tensors: the three slip candidates (a swap
mirrors the spectrum, which the asymmetry cannot tell from aligned, so it is
a manual option) scored in complex64 as NumPy does in the JAX package, and
the locked repair applied with the previous segment's last sample carried
in. They compute wherever the planes lie; on the card only the chosen index,
one int, comes back to the host.
"""

from __future__ import annotations

import numpy as np
import torch

IQ_GAIN_BALANCE_DEFAULT = 1.020  # SDR.setIQgainBalance (RadioDSP_SDR_RX.ino:135)
_SLIP_REPAIRS = (0, 2, 3)        # identity, delay I, delay Q


def iq_gain_balance(iq: torch.Tensor, gain: float = IQ_GAIN_BALANCE_DEFAULT) -> torch.Tensor:
    """Scale the Q channel to balance codec channel gains."""
    return torch.complex(iq.real, iq.imag * gain)


def _delay1(x: torch.Tensor) -> torch.Tensor:
    """x delayed one sample along the last axis, the first sample repeated."""
    return torch.cat([x[..., :1], x[..., :-1]], dim=-1)


def _candidates(iq: torch.Tensor) -> torch.Tensor:
    """(4, ..., n) stack: identity, swapped, I delayed 1, Q delayed 1."""
    i, q = iq.real, iq.imag
    return torch.stack([torch.complex(i, q), torch.complex(q, i),
                        torch.complex(_delay1(i), q), torch.complex(i, _delay1(q))])


def spectral_asymmetry(iq: torch.Tensor) -> torch.Tensor:
    """|E+ - E-| / (E+ + E-) over the last axis: an image-rejection proxy."""
    spec = torch.fft.fft(iq, dim=-1)
    n = spec.shape[-1]
    pos = (spec[..., 1:n // 2].abs() ** 2).sum(-1)
    neg = (spec[..., n // 2 + 1:].abs() ** 2).sum(-1)
    return (pos - neg).abs() / (pos + neg + 1e-12)


def detect_iq_error(iq: torch.Tensor) -> torch.Tensor:
    """The index (0..3, a 0-d tensor) of the repair maximising the spectral
    asymmetry, averaged over any leading axes."""
    scores = spectral_asymmetry(_candidates(iq))
    if scores.dim() > 1:
        scores = scores.mean(dim=tuple(range(1, scores.dim())))
    return torch.argmax(scores)


def repair_iq(iq: torch.Tensor, repair_idx) -> torch.Tensor:
    """Apply repair ``repair_idx`` (from ``detect_iq_error``) to the stream."""
    return _candidates(iq)[repair_idx]


def detect_iq_error_host(xr, xi) -> int:
    """The one-sample I2S slip of planar f32 IQ (..., n): 0 (aligned), 2
    (delay I) or 3 (delay Q), whichever candidate has the largest spectral
    asymmetry (mean over leading axes), the first of equals. Scored in
    complex64 and float32 as the JAX package's NumPy detector is, where the
    planes lie; returns a Python int (one scalar read back)."""
    xr = torch.as_tensor(xr, dtype=torch.float32)
    xi = torch.as_tensor(xi, dtype=torch.float32, device=xr.device)
    z = torch.stack([torch.complex(xr, xi), torch.complex(_delay1(xr), xi),
                     torch.complex(xr, _delay1(xi))])
    score = spectral_asymmetry(z).reshape(len(_SLIP_REPAIRS), -1).mean(-1)
    return _SLIP_REPAIRS[int(torch.argmax(score))]


def apply_repair_planar_host(xr, xi, idx: int, carry=None):
    """Apply a locked repair index to one planar segment, streaming-safe.

    carry: (last_i, last_q), each (..., 1), of the previous RAW segment
    (None at stream start, where a delay repeats the first sample, as
    ``_candidates`` does). Returns (xr', xi', new_carry)."""
    xr = torch.as_tensor(xr, dtype=torch.float32)
    xi = torch.as_tensor(xi, dtype=torch.float32, device=xr.device)
    new_carry = (xr[..., -1:].clone(), xi[..., -1:].clone())
    ci = carry[0] if carry is not None else xr[..., :1]
    cq = carry[1] if carry is not None else xi[..., :1]
    if idx == 1:                                   # swap I/Q
        xr, xi = xi, xr
    elif idx == 2:                                 # delay I one sample
        xr = torch.cat([ci, xr[..., :-1]], dim=-1)
    elif idx == 3:                                 # delay Q one sample
        xi = torch.cat([cq, xi[..., :-1]], dim=-1)
    return xr, xi, new_carry


def preprocess(iq: torch.Tensor, gain_balance: float = IQ_GAIN_BALANCE_DEFAULT,
               auto_repair: bool = True) -> torch.Tensor:
    """The whole preprocessor: optional automatic I2S repair, then the IQ
    gain balance."""
    if auto_repair:
        iq = repair_iq(iq, detect_iq_error(iq))
    return iq_gain_balance(iq, gain_balance)
