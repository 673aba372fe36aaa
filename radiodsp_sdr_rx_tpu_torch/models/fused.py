"""Many-channel fused SSB receiver bank (``radiodsp_sdr_rx_tpu/models/fused.py:43-190``).

``FusedSSBBank(backend="sweep")`` runs the whole chain (NCO mix, sideband
filter + SSB demod, AGC, PBT) for every channel in ONE kernel launch per
segment (ops/sweep.sweep_full_chain). The DDS phase, framing tails and AGC
envelope thread from call to call in a ``FusedBankState``, with the sweep
backend's meaning: ``sb_tail`` is the RAW input's last block [re|im], which
the kernel re-scales and re-mixes. The staged backend and the noise blanker
are later slices of the port (ROADMAP.md, queue 1) and raise
``NotImplementedError`` here.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.ops import nco
from radiodsp_sdr_rx_tpu_torch.ops.sweep import sweep_full_chain
from radiodsp_sdr_rx_tpu_torch.utils.convert import params_from_numpy, resolve_device

_BLOCK = 128


class FusedBankState(NamedTuple):
    """Carry of the fused bank; fields and meaning as the JAX ``FusedBankState``
    (sweep backend). DDS words are int64 in [0, 2^32)."""

    nco_phase: torch.Tensor   # (C,) int64 DDS phase words
    sb_tail: torch.Tensor     # (C, 256) f32 RAW input last block [re|im]
    audio_tail: torch.Tensor  # (C, 128) f32 PBT framing tail (post-AGC audio)
    agc_env: torch.Tensor     # (C,) f32
    nb_avg: torch.Tensor      # (C,) f32 noise-blanker carry (unused until NB)
    nb_mask: torch.Tensor     # (C, 128) f32 noise-blanker keep mask (unused until NB)


class FusedSSBBank:
    """Many-channel fused SSB receiver (USB/LSB/CW/RTTY + AGC).

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` to run the plain PyTorch version.
    """

    def __init__(self, config: ReceiverConfig, freqs_hz, backend: str = "sweep",
                 device=None):
        if config.mode in (DemodMode.AM, DemodMode.SAM):
            raise ValueError("FusedSSBBank covers SSB modes")
        if config.nr.kind != "off":
            raise ValueError("NR configs are not part of FusedSSBBank")
        if backend not in ("staged", "sweep"):
            raise ValueError(backend)
        if backend == "staged":
            raise NotImplementedError(
                "backend='staged' (kernels K2a/K2b) is the next slice of the "
                "port: ROADMAP.md queue 1, 'Staged FusedSSBBank and the noise "
                "blanker'")
        if config.noise_blanker:
            raise NotImplementedError(
                "noise_blanker=True (the K1 nb variant) is the next slice of the "
                "port: ROADMAP.md queue 1, 'Staged FusedSSBBank and the noise "
                "blanker'")
        self.config = config
        self.device = resolve_device(device)
        self.n_channels = len(freqs_hz)
        self.params = params_from_numpy(build_params(config)._asdict(), self.device)
        incs = np.stack([
            nco.freq_to_phase_inc(
                f - config.tuning_offset - config.capture_center_freq,
                config.sample_rate)
            for f in np.asarray(freqs_hz, np.float64)])
        self.incs = torch.as_tensor(incs.astype(np.int64), device=self.device)

    def init_state(self) -> FusedBankState:
        c, dev = self.n_channels, self.device
        return FusedBankState(
            nco_phase=torch.zeros(c, dtype=torch.int64, device=dev),
            sb_tail=torch.zeros(c, 2 * _BLOCK, device=dev),
            audio_tail=torch.zeros(c, _BLOCK, device=dev),
            agc_env=torch.full((c,), 1e-6, device=dev),
            nb_avg=torch.zeros(c, device=dev),
            nb_mask=torch.ones(c, _BLOCK, device=dev),
        )

    def chain_args(self, xr: torch.Tensor, xi: torch.Tensor,
                   state: FusedBankState) -> tuple:
        """The positional arguments of ``sweep_full_chain`` for one segment."""
        p = self.params
        return (xr, xi, self.incs, state.nco_phase, p.w_ssb, p.w_pbt,
                state.sb_tail[:, :_BLOCK].contiguous(),
                state.sb_tail[:, _BLOCK:].contiguous(),
                state.audio_tail, state.agc_env,
                p.agc_release, p.agc_target, p.agc_max_gain, p.agc_enabled,
                p.output_gain, p.input_gain, self.config.iq_gain_balance)

    def process_planar(self, xr, xi, state: FusedBankState):
        """One segment of planar f32 IQ, (C, n) each with n a multiple of 128.
        Returns ({"audio_l", "audio_r"}, next state)."""
        xr = torch.as_tensor(xr, dtype=torch.float32, device=self.device).contiguous()
        xi = torch.as_tensor(xi, dtype=torch.float32, device=self.device).contiguous()
        l, r, atail, env = sweep_full_chain(*self.chain_args(xr, xi, state))
        new_state = FusedBankState(
            nco_phase=nco.advance_phase(state.nco_phase, xr.shape[-1], self.incs),
            sb_tail=torch.cat([xr[:, -_BLOCK:], xi[:, -_BLOCK:]], dim=-1),
            audio_tail=atail,
            agc_env=env,
            nb_avg=state.nb_avg, nb_mask=state.nb_mask,
        )
        return {"audio_l": l, "audio_r": r}, new_state

    def process(self, iq, state: FusedBankState):
        """Complex IQ at the host boundary: (C, n), or (n,) for every channel."""
        iq = np.asarray(iq)
        if iq.ndim == 1:
            iq = np.broadcast_to(iq, (self.n_channels,) + iq.shape)
        return self.process_planar(
            np.ascontiguousarray(iq.real, np.float32),
            np.ascontiguousarray(iq.imag, np.float32), state)
