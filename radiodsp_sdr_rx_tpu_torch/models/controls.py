"""Menu/controls finite-state machine — the reference UI as a pure model
(the port's copy of ``radiodsp_sdr_rx_tpu/models/controls.py``).

Replaces the 4-level menu FSM driven by a rotary encoder + 3 buttons
(ref: src/RadioDSP_SDR_RX/RDSP_controls.h:27-74 menu levels, :617-681 encoder
dispatch, :687-751 button dispatch; level ids RDSP_general_includes.h:53-59).
The FSM mutates a ``ReceiverConfig``/``VFO`` pair instead of globals; a UI (or
test) feeds it abstract events.

Events:
  ``encoder(+/-n)``  — tune (RUNNING) or move menu level (MENU)
  ``button_menu()``  — BUTTON_D2: toggle MENU/RUNNING mode
  ``button_a()``     — BUTTON_D3: mode / filter / scope / (PBT lo via encoder)
  ``button_b()``     — BUTTON_D6: step / NR / AGC / (PBT hi via encoder)
"""

from __future__ import annotations

import dataclasses

from radiodsp_sdr_rx_tpu_torch.models.config import (
    MAX_HI, MAX_LOW, MIN_HI, MIN_LOW,
    AGCMode, AudioFilter, DemodMode, NRMode, ReceiverConfig,
)
from radiodsp_sdr_rx_tpu_torch.models.vfo import VFO

# Menu levels (RDSP_general_includes.h:56-59)
L1_MODE_TS, L2_FLT_NR, L3_SCOPE_AGC, L4_PBT_LH = 1, 2, 3, 4

# Cycle orders per the reference menus
_MODE_CYCLE = [DemodMode.CW_NARROW, DemodMode.CW, DemodMode.USB, DemodMode.LSB,
               DemodMode.AM, DemodMode.SAM, DemodMode.RTTY]
_FILTER_CYCLE = [AudioFilter.CW_500, AudioFilter.F2100, AudioFilter.F2700,
                 AudioFilter.F3100, AudioFilter.AM_3900]
_AGC_CYCLE = [AGCMode.OFF, AGCMode.FAST, AGCMode.MEDIUM, AGCMode.SLOW]
_NR_CYCLE = [NRMode.OFF, NRMode.NOTCH, NRMode.DNR1, NRMode.DNR2, NRMode.DNR3,
             NRMode.DNR4]
PBT_STEP_HZ = 50.0  # checkPBT_* step (RDSP_controls.h:574-605)


@dataclasses.dataclass
class ControlPlane:
    """The control-plane state: config + VFO + menu position."""

    config: ReceiverConfig = dataclasses.field(default_factory=ReceiverConfig)
    vfo: VFO = dataclasses.field(default_factory=VFO)
    menu_mode: bool = False          # iMode (RUNNING_MODE default)
    menu_level: int = L1_MODE_TS     # iMenuLevel
    scope: int = 1                   # nscope: 0 panadapter, 1 audio scope

    def __post_init__(self):
        self.vfo.freq = int(self.config.vfo_freq)

    # -- events ---------------------------------------------------------------

    def button_menu(self) -> None:
        """BUTTON_D2: toggle MENU <-> RUNNING (checkCmd, RDSP_controls.h:689-699)."""
        self.menu_mode = not self.menu_mode

    def encoder(self, detents: int) -> None:
        """Encoder rotation. RUNNING: tune (or PBT at level 4); MENU: move level
        (setFreq, RDSP_controls.h:617-681)."""
        if self.menu_mode:
            if detents > 0 and self.menu_level < L4_PBT_LH:
                self.menu_level += 1
            elif detents < 0 and self.menu_level > L1_MODE_TS:
                self.menu_level -= 1
            return
        self.vfo.tune(detents)
        self.config = self.config.with_(vfo_freq=float(self.vfo.freq))

    def pbt_adjust(self, which: str, direction: int) -> None:
        """PBT lo/hi +-50 Hz within legal ranges (checkPBT_Increase/Decrease,
        RDSP_controls.h:569-612). Active only at menu level 4."""
        if self.menu_level != L4_PBT_LH:
            return
        if which == "lo":
            lo = self.config.pbt_lo + direction * PBT_STEP_HZ
            if MIN_LOW <= lo <= MAX_LOW:
                self.config = self.config.with_(pbt_lo=lo)
        else:
            hi = self.config.pbt_hi + direction * PBT_STEP_HZ
            if MIN_HI <= hi <= MAX_HI:
                self.config = self.config.with_(pbt_hi=hi)

    def button_a(self) -> None:
        """BUTTON_D3 dispatch by menu level (checkCmd, RDSP_controls.h:703-725)."""
        if self.menu_mode:
            return
        if self.menu_level == L1_MODE_TS:
            self._cycle_mode()
        elif self.menu_level == L2_FLT_NR:
            self._cycle_filter()
        elif self.menu_level == L3_SCOPE_AGC:
            self.scope = 0 if self.scope else 1
        # L4: PBT handled via pbt_adjust on encoder

    def button_b(self) -> None:
        """BUTTON_D6 dispatch by menu level (checkCmd, RDSP_controls.h:726-749)."""
        if self.menu_mode:
            return
        if self.menu_level == L1_MODE_TS:
            self.vfo.cycle_step()
        elif self.menu_level == L2_FLT_NR:
            self._cycle_nr()
        elif self.menu_level == L3_SCOPE_AGC:
            self._cycle_agc()

    # -- cycles ---------------------------------------------------------------

    def _cycle_mode(self) -> None:
        """tuningMode: advance demod mode; filter preset follows the mode
        coupling (RDSP_controls.h:330-423)."""
        i = _MODE_CYCLE.index(self.config.mode)
        mode = _MODE_CYCLE[(i + 1) % len(_MODE_CYCLE)]
        self.config = self.config.with_(mode=mode, audio_filter=None)

    def _cycle_filter(self) -> None:
        """filterMode cycle (RDSP_controls.h:149-191)."""
        cur = self.config.effective_audio_filter
        i = _FILTER_CYCLE.index(cur) if cur in _FILTER_CYCLE else 0
        self.config = self.config.with_(
            audio_filter=_FILTER_CYCLE[(i + 1) % len(_FILTER_CYCLE)]
        )

    def _cycle_agc(self) -> None:
        """setAgc cycle (RDSP_controls.h:196-232)."""
        i = _AGC_CYCLE.index(self.config.agc)
        self.config = self.config.with_(agc=_AGC_CYCLE[(i + 1) % len(_AGC_CYCLE)])

    def _cycle_nr(self) -> None:
        """setNRMode cycle off->NOTCH->DNR1..4 (RDSP_controls.h:237-297)."""
        cur = self.config.nr
        i = _NR_CYCLE.index(cur) if cur in _NR_CYCLE else 0
        self.config = self.config.with_(nr=_NR_CYCLE[(i + 1) % len(_NR_CYCLE)])
