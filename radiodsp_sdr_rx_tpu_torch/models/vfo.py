"""VFO model: tuning steps, clamps, auto step-down — pure data, no Si5351
(the port's copy of ``radiodsp_sdr_rx_tpu/models/vfo.py``).

Replaces the reference's VFO/encoder plumbing (ref:
src/RadioDSP_SDR_RX/RDSP_controls.h:79-144 ``tuningStep``, :453-564 ``showFreq``
auto step-down, :617-681 ``setFreq``; limits RDSP_general_includes.h:68-72).
The "LO" here is the receiver NCO: ``VFO.freq`` feeds
``ReceiverConfig.vfo_freq``; there is no I2C transaction, so the Si5351's
4x-clock and 33000 ppb correction (RDSP_controls.h:429-448) exist only as the
documented relation ``lo_clock_hz = 4 * (freq - tuning_offset)`` for users
driving real QSD hardware from captures.
"""

from __future__ import annotations

import dataclasses

from radiodsp_sdr_rx_tpu_torch.models.config import BOTTOM_FREQ, TOP_FREQ

# tndx -> step in Hz (tuningStep, RDSP_controls.h:86-133)
TUNING_STEPS = (1, 10, 100, 1_000, 10_000, 100_000, 1_000_000)
MIN_TS = 1  # minimum step index after cycling (RDSP_controls.h:137 "10 Hz")

# si5351.set_correction(33000) — the reference board's measured crystal error
# in parts-per-billion (initVfo, RDSP_controls.h:433). The library pre-scales
# the programmed PLL word so the physical output lands on target despite the
# crystal error; the *uncorrected* synthesizer would emit
# f * (1 + SI5351_CORRECTION_PPB/1e9).
SI5351_CORRECTION_PPB = 33_000


@dataclasses.dataclass
class VFO:
    """Mutable tuning model with the reference's step-cycling semantics."""

    freq: int = 7_050_000            # vfoFreq default (RDSP_general_includes.h:72)
    step_index: int = 3              # tndx default = 1 kHz
    max_step_index: int = 6

    @property
    def step(self) -> int:
        return TUNING_STEPS[self.step_index]

    def cycle_step(self) -> None:
        """Advance to the next step (wraps to MIN_TS past max), per tuningStep's
        post-increment cycle (RDSP_controls.h:135-142)."""
        if self.step_index >= self.max_step_index:
            self.step_index = MIN_TS
        else:
            self.step_index += 1

    def _auto_step_down(self) -> None:
        """showFreq's automatic step-down near range edges and max-step rules
        (RDSP_controls.h:459-483, 504-560)."""
        if 1_000_000 <= self.freq <= 1_999_999 and self.step == 1_000_000:
            self.step_index = 5
        if 100_000 <= self.freq <= 199_999 and self.step == 100_000:
            self.step_index = 4
        if 10_000 <= self.freq <= 19_999 and self.step == 10_000:
            self.step_index = 3
        if self.freq < 99_999:
            self.max_step_index = 4
        elif self.freq < 999_999:
            self.max_step_index = 5
        else:
            self.max_step_index = 6
        self.step_index = min(self.step_index, self.max_step_index)

    def tune(self, increments: int) -> int:
        """Move by ``increments`` encoder detents (sign = direction), clamped to
        [30 kHz, 30 MHz] (setFreq, RDSP_controls.h:634-654). Returns freq."""
        self.freq = int(min(TOP_FREQ, max(BOTTOM_FREQ, self.freq + increments * self.step)))
        self._auto_step_down()
        return self.freq

    def lo_clock_hz(self, tuning_offset: float = 0.0,
                    corrected: bool = True) -> float:
        """The Si5351 CLK0 frequency the reference would program: 4x quadrature
        clock (sendFreq: ``set_freq((vfoFreq - TuningOffset) * 400ULL)`` in
        centi-Hz, RDSP_controls.h:445-448).

        ``corrected=True`` (default) is the physical output after the library
        applies the board's 33000 ppb crystal correction
        (``set_correction(33000)``, RDSP_controls.h:433) — i.e. the target
        itself. ``corrected=False`` models the raw synthesizer output an
        uncorrected crystal would produce, for users replaying captures from
        real QSD hardware who need the actual LO error."""
        target = 4.0 * (self.freq - tuning_offset)
        if corrected:
            return target
        return target * (1.0 + SI5351_CORRECTION_PPB * 1e-9)
