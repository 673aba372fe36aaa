"""The receive chain with its NR stage folded in, one kernel launch per segment.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_chain_lanes.py``:
``sweep_lanes_chain`` (:748), kernel ``_lanes_chain_kernel`` (:98), with an
NR stage: demod "ssb", "am" or "sam" x nr "denoise", "notch" or "spectral"
x the noise blanker, the seventeen routes of the JAX
``FusedNRBank(fold=True)`` that reach it; SSB + spectral without the
blanker is K4 (``ops/sweep_spec.py``), which launches through ``launch``
too. The chain is ``ops/sweep.py``'s with the NR stage
in ``ReceiverBank``'s order:

  notch:    the LMS error e replaces the demodulated audio (after the AM/SAM
            DC blocker) before the AGC;
  denoise:  the LMS prediction y of the post-PBT L, times 1.1, then the
            output gain; no R (the bank copies L);
  spectral: spectral subtraction of the post-PBT [l | r], then the output
            gain.

The LMS is ``ops/lms.py``'s per-sample recurrence, the function the JAX
kernel's grouped macro computes; SAM re-seeds its PLL where ``sam.Reseed``
says. CUDA tensors launch ``csrc/sweep_denoise.cu``, ``sweep_notch.cu`` or
``sweep_spec.cu`` (one template, ``csrc/sweep_chain.cuh``; through
``sweep.launch_chain``) or raise; CPU tensors run ``sweep.chain_plain``, the
plain version the tests and
``chip_smoke.py`` hold the kernels to. ``LAUNCHES`` counts each kernel's
launches by name (``kernel_name``). The JAX wrapper's lane padding, chunk
and precision knobs have no meaning here: any channel count runs, and the
carries come back for the given channels only.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from radiodsp_sdr_rx_tpu_torch.ops import sweep
from radiodsp_sdr_rx_tpu_torch.ops.sweep import LmsArgs, SamArgs, SpecArgs

DEMODS = ("ssb", "am", "sam")
NR_STAGES = ("denoise", "notch", "spectral")


def kernel_name(demod: str, nr: str, nb: bool) -> str:
    """The name a route's kernel is counted and reported under."""
    return f"lanes_{demod}_{nr}{'_nb' if nb else ''}"


KERNELS = tuple(kernel_name(d, nr, nb) for nr in NR_STAGES for d in DEMODS
                for nb in (False, True) if (d, nr, nb) != ("ssb", "spectral", False))
LAUNCHES = dict.fromkeys(KERNELS, 0)


class LanesOut(NamedTuple):
    """A segment's outputs; None where the route has no such stage."""

    audio_l: torch.Tensor
    audio_r: torch.Tensor | None     # None with nr="denoise"
    audio_tail: torch.Tensor         # (C, 128) post-AGC audio tail
    agc_env: torch.Tensor            # (C,)
    dc: torch.Tensor | None          # (C, 2) am, sam
    pll: torch.Tensor | None         # (2, C) sam
    lms_weights: torch.Tensor | None  # (C, 96) denoise, notch
    lms_window: torch.Tensor | None   # (C, 96)
    lms_delay: torch.Tensor | None    # (C, 128)
    nfloor: torch.Tensor | None       # (C,) spectral
    spec_tail_l: torch.Tensor | None  # (C, 128)
    spec_tail_r: torch.Tensor | None  # (C, 128)
    nb_avg: torch.Tensor | None       # (C,) blanker
    nb_mask: torch.Tensor | None      # (C, 128)


def _demod(dc0, sam) -> str:
    return "sam" if sam is not None else "am" if dc0 is not None else "ssb"


def _one_stage(lms: LmsArgs | None, spec: SpecArgs | None):
    if (lms is None) == (spec is None):
        raise ValueError("one NR stage: an LmsArgs (denoise, notch) or a SpecArgs (spectral)")


def _named(out: tuple, dc0, sam, lms, spec, nb) -> LanesOut:
    """A chain's tuple, in ``sweep.chain_plain``'s order (``sweep.launch_chain``
    returns the same), by field."""
    l, r, atail, env, *rest = out
    take = (lambda k: tuple(rest.pop(0) for _ in range(k)))
    dc = take(1)[0] if dc0 is not None else None
    pll = take(1)[0] if sam is not None else None
    lms_out = take(3) if lms is not None else (None,) * 3
    spec_out = take(3) if spec is not None else (None,) * 3
    nb_out = take(2) if nb else (None, None)
    return LanesOut(l, r, atail, env, dc, pll, *lms_out, *spec_out, *nb_out)


def _run(chain, *args) -> LanesOut:
    """``chain`` (``sweep.chain_plain`` or ``sweep.launch_chain``) on
    ``sweep_lanes_chain``'s arguments."""
    *head, dc0, sam, lms, spec = args
    _one_stage(lms, spec)
    out = chain(*head, dc0, sam=sam, lms=lms, spec=spec)
    return _named(out, dc0, sam, lms, spec, nb=head[17])


def sweep_lanes_chain_plain(*args) -> LanesOut:
    """Plain PyTorch version of ``sweep_lanes_chain``."""
    return _run(sweep.chain_plain, *args)


def launch(*args) -> LanesOut:
    """``sweep_lanes_chain`` on the card, its launch not counted (K4's
    wrapper counts its own)."""
    return _run(sweep.launch_chain, *args)


def sweep_lanes_chain(xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail, env0,
                      agc_release, agc_target, agc_max_gain, agc_enabled, out_gain, in_gain,
                      iq_balance, nb, nb_thresh_db, nb_tau, nb_avg0, nb_mask0, dc0=None,
                      sam: SamArgs | None = None, lms: LmsArgs | None = None,
                      spec: SpecArgs | None = None) -> LanesOut:
    """Whole receive chain with one NR stage (the JAX ``sweep_lanes_chain``
    with ``nr`` "denoise", "notch" or "spectral"); arguments as
    ``sweep.sweep_full_chain`` (SSB; w is ``w_ssb`` (512, 128)), with ``dc0``
    as ``sweep.sweep_am_chain`` (AM; w is ``w_sideband`` (512, 256)), with
    ``sam`` too as ``sweep.sweep_sam_chain`` (SAM; ``sweep.SamArgs``: the PLL
    carry, gains and re-seed schedule), plus the NR stage, exactly one of:

      lms:   ``sweep.LmsArgs`` (weights, window, delay, first, mu, mode)
      spec:  ``sweep.SpecArgs`` (W_fwd, W_inv, nfloor0, tail_l, tail_r, level)

    Returns a ``LanesOut``. CPU tensors run the plain version; CUDA tensors
    launch the kernel, or raise.
    """
    args = (xr, xi, inc, phase0, w, w_pbt, tail_r, tail_i, audio_tail, env0, agc_release,
            agc_target, agc_max_gain, agc_enabled, out_gain, in_gain, iq_balance, nb,
            nb_thresh_db, nb_tau, nb_avg0, nb_mask0, dc0, sam, lms, spec)
    if xr.device.type == "cpu":
        return sweep_lanes_chain_plain(*args)
    name = kernel_name(_demod(dc0, sam), "spectral" if spec is not None else
                       lms.mode if lms is not None else "none", nb)
    if name not in LAUNCHES:
        raise ValueError(f"{name} is not a route of the NR chain kernel (SSB + spectral "
                         "without the blanker is ops/sweep_spec.sweep_spec_chain)")
    out = launch(*args)
    LAUNCHES[name] += 1
    return out
