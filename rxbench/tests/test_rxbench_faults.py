"""The check that decides ``correct``, on the CPU at a tiny size: a sound
run is correct, a run with the timed path broken underneath is not, once
for each fault the cells can have, and so is the control, the reference
one precision below the configuration's put in the program's place."""

import pytest
import torch

from rxbench import control, harness

TINY = {"channels": 4, "capture_samples": 4096}
SPAN = {"usb128.seg19": 1024, "usb128_dnr2.seg19": 1024, "usb128.live16k": 512}
CELLS = sorted(SPAN)


def run(cell, entry=None, seed=5):
    return harness.run_cell(cell, seed, 0.3, False, device="cpu", entry=entry,
                            sizes=dict(TINY, span=SPAN[cell]))


def same_state(out, new, old):
    return out, old


def half_the_channels(out, new, old):
    half = out["audio_l"].shape[0] // 2
    return {k: torch.cat([v[:half], torch.zeros_like(v[half:])]) for k, v in out.items()}, new


def altered_answer(out, new, old):
    left = out["audio_l"].clone()
    left[0, 7] += 1e-3 * left.abs().max()
    return dict(out, audio_l=left), new


def last_call_altered(out, new, old, call):
    """One answer altered, only in the last call of each capture (4 at the
    tiny size)."""
    return altered_answer(out, new, old) if call == 3 else (out, new)


FAULTS = {"same_state": same_state, "half_the_channels": half_the_channels,
          "altered_answer": altered_answer, "last_call_altered": last_call_altered}


def broken(fault):
    """The configuration's entry with ``fault`` applied to every call."""
    from rxbench.entries import fused_bank

    fn = FAULTS[fault]

    class Broken:
        def __init__(self, bank):
            self.bank = bank
            self.n_channels, self.config = bank.n_channels, bank.config

        def init_state(self):
            self.call = 0
            return self.bank.init_state()

        def process_planar(self, xr, xi, state):
            out, new = self.bank.process_planar(xr, xi, state)
            self.call += 1
            if fn is last_call_altered:
                return fn(out, new, state, self.call - 1)
            return fn(out, new, state)

    return lambda s, d: Broken(fused_bank.make(s, d)), fused_bank.state_view


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_is_correct(cell):
    r = run(cell)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["same_state", "half_the_channels", "altered_answer"])
def test_broken_path_is_not_correct(cell, fault):
    r = run(cell, entry=broken(fault))
    assert not r["correct"] and r["failed"] > 0


@pytest.mark.parametrize("seed", [5, 6, 2**31 + 9])
@pytest.mark.parametrize("cell", CELLS)
def test_a_fault_at_one_position_of_the_capture_is_seen_on_every_seed(cell, seed):
    """Every call of the sampled pass is compared, so a fault confined to
    one call position cannot slip through."""
    r = run(cell, entry=broken("last_call_altered"), seed=seed)
    assert not r["correct"] and r["failed"] == 1


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    r = run(cell, entry=control.control_entry())
    assert not r["correct"]
    assert r["checks"]["audio"]["value"] > r["checks"]["audio"]["limit"]
