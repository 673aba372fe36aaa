"""Live appliance loop: the reference's ``loop()`` as a host-side runtime
(``radiodsp_sdr_rx_tpu/models/appliance.py``).

The reference interleaves demodulation, panadapter/waterfall repaint
(~5.7 Hz), S-meter updates and encoder/button handling continuously
(RadioDSP_SDR_RX.ino:195-233; paint paths RDSP_display.h:74-190,235-401).
This module is that appliance with the hardware swapped for framework
surfaces:

  rotary encoder + buttons  ->  abstract events fed to ControlPlane
  audio ISR + conv loop     ->  Receiver.process over IQ blocks
  FFT nodes + TFT           ->  models/metrics.analyze + ASCII renderers

The receiver and the scopes run on one device (``device=None``: the card);
each block goes there once, the scope reads the receiver's audio there, and
``render_frame`` reads what it paints back to the host in one copy.

``Appliance`` is headless and synchronous (testable without a terminal);
``cli.py tui`` wraps it with raw-terminal key polling and ANSI repaints.

Events (tuples):
  ("encoder", n)  — n detents, sign = direction (tune / menu move / PBT)
  ("menu",)       — BUTTON_D2: toggle MENU <-> RUNNING
  ("a",) ("b",)   — BUTTON_D3 / BUTTON_D6 per menu level
  ("pbt", "lo"|"hi") — select which PBT edge the encoder adjusts at level 4
"""

from __future__ import annotations

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.controls import L4_PBT_LH, ControlPlane
from radiodsp_sdr_rx_tpu_torch.models.metrics import analyze, scope_init
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver
from radiodsp_sdr_rx_tpu_torch.utils import display as disp

# the config fields the receiver's chain is specialised on: a change of any
# of them builds a new Receiver (radiodsp_sdr_rx_tpu/models/appliance.py's
# statics test)
_STATICS = ("mode", "nr", "noise_blanker", "quantize_output", "fft_length", "sample_rate",
            "conv_first", "conv_inline_denoise", "matmul_precision")


class Appliance:
    """Config + VFO + receiver + scopes, advanced block-by-block.

    >>> app = Appliance(ReceiverConfig(mode=DemodMode.USB, ...))
    >>> out = app.step(iq_block, events=[("encoder", +2)])
    >>> print(app.render_frame())

    ``device=None`` means the CUDA card and raises without one; pass
    ``device="cpu"`` for the plain PyTorch versions.
    """

    def __init__(self, config: ReceiverConfig, block: int = 4096,
                 metrics: bool = True, device=None):
        if block % 512:
            raise ValueError("block must be a multiple of 512 (scope frames)")
        self.plane = ControlPlane(config=config)
        self.receiver = Receiver(self.plane.config, device)
        self.device = self.receiver.device
        self.state = self.receiver.init_state()
        self.block = block
        self.metrics_enabled = metrics
        self.scope_state = scope_init(self.device) if metrics else None
        self.metrics: dict | None = None
        self.pbt_sel = "lo"
        self.blocks_processed = 0

    # -- control plane ---------------------------------------------------

    def apply_events(self, events) -> bool:
        """Dispatch UI events; swap the receiver when the config changed.
        Returns True when a reconfiguration happened."""
        plane = self.plane
        before = plane.config
        for ev in events:
            kind = ev[0]
            if kind == "encoder":
                if (not plane.menu_mode) and plane.menu_level == L4_PBT_LH:
                    # PBT takes priority over tuning at level 4
                    # (checkCmd, RDSP_controls.h:571-612)
                    steps = int(ev[1])
                    for _ in range(abs(steps)):
                        plane.pbt_adjust(self.pbt_sel,
                                         1 if steps > 0 else -1)
                else:
                    plane.encoder(int(ev[1]))
            elif kind == "menu":
                plane.button_menu()
            elif kind == "a":
                plane.button_a()
            elif kind == "b":
                plane.button_b()
            elif kind == "pbt":
                self.pbt_sel = ev[1]
            else:
                raise ValueError(f"unknown event {ev!r}")
        if plane.config is before:
            return False
        self._swap_receiver(plane.config)
        return True

    def _swap_receiver(self, cfg: ReceiverConfig) -> None:
        """Functional reconfiguration: same statics -> the receiver's chain
        settings and its unchanged parameter tensors kept, the new ones
        copied to the device (``Receiver.retuned``); a static change
        (mode/NR) -> a new Receiver. DSP state and the locked I2S repair
        carry over either way — the reference likewise keeps its filter/AGC
        state across menu edits (reInitializeFilter swaps only coefficients,
        RDSP_convolutional.h:209-224)."""
        old = self.receiver
        if all(getattr(cfg, k) == getattr(old.config, k) for k in _STATICS):
            self.receiver = old.retuned(cfg)
        else:
            self.receiver = Receiver(cfg, self.device)
            self.receiver._repair_idx = old._repair_idx
            self.receiver._repair_carry = old._repair_carry

    # -- signal path -------------------------------------------------------

    def step(self, iq_block: np.ndarray, events=()) -> dict:
        """One appliance iteration: events -> demod -> scopes.
        iq_block: (block,) complex64. Returns {audio_l, audio_r, reconfigured},
        the audio as tensors on the appliance's device.
        """
        if len(iq_block) != self.block:
            raise ValueError(f"need a full block of {self.block}")
        reconfigured = self.apply_events(events)
        iq = torch.as_tensor(np.asarray(iq_block, np.complex64)).to(self.device)
        out, self.state = self.receiver.process(iq, self.state)
        if self.metrics_enabled:
            self.metrics, self.scope_state = analyze(
                iq, out["audio_l"], self.scope_state,
                sample_rate=self.plane.config.sample_rate,
                audio_naverage=max(1, min(30, self.block // 512)))
        self.blocks_processed += 1
        return {"audio_l": out["audio_l"], "audio_r": out["audio_r"],
                "reconfigured": reconfigured}

    # -- presentation --------------------------------------------------------

    def _painted(self, wf_rows: int) -> dict | None:
        """What the active scope paints, on the host, in one copy."""
        m = self.metrics
        if m is None:
            return None
        parts = {"s_units": m["s_units"].reshape(1), "s9_plus_db": m["s9_plus_db"].reshape(1),
                 "view": m["view"]}
        if self.plane.scope == 0:
            parts["waterfall"] = m["waterfall"][:wf_rows]
        else:
            parts["audio"] = m["audio_spectrum"][-1]
        flat = torch.cat([v.float().reshape(-1) for v in parts.values()]).cpu().numpy()
        out, pos = {}, 0
        for k, v in parts.items():
            out[k] = flat[pos:pos + v.numel()].reshape(v.shape)
            pos += v.numel()
        return out

    def render_frame(self, height: int = 12, wf_rows: int = 14) -> str:
        """Status header + tuning cursor + active scope + S-meter line —
        the full reference screen as ASCII (status fields RDSP_display.h:
        74-190; panadapter+waterfall :235-324; dual scope :380-401)."""
        plane = self.plane
        m = self._painted(wf_rows)
        s_val = None
        if m is not None:
            s_val = float(m["s_units"][0]) + (float(m["s9_plus_db"][0])
                                              if float(m["s9_plus_db"][0]) > 0
                                              else 0.0)
        head = disp.render_status_ascii(
            plane.config, plane.vfo, s_units=s_val,
            menu_level=plane.menu_level if plane.menu_mode else None)
        lines = [head]
        if m is None:
            return "\n".join(lines)
        view = m["view"]
        if plane.scope == 0:
            lines.append(disp.render_spectrum_ascii(view, height=height))
            lines.append(disp.render_spectrum_cursor())
            lines.append(disp.render_waterfall_ascii(m["waterfall"]))
        else:
            lines.append(disp.render_double_spectrum_ascii(
                view, m["audio"], height=height))
        s = float(m["s_units"][0])
        plus = float(m["s9_plus_db"][0])
        lines.append(f"S-meter: S{s:.0f}" + (f"+{plus:.0f}dB" if plus > 0
                                             else ""))
        return "\n".join(lines)
