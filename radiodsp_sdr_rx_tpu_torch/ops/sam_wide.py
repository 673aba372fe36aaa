"""The SAM chain for banks of more than 128 channels: K7.

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sam_wide.py``:
``sweep_sam_wide`` (:325, kernel ``_sam_wide_kernel`` :49) runs the whole SAM
chain with G lane groups sharing one serial PLL stream. Per channel it is
``ops/sweep.sweep_sam_chain``'s function, carries and return order; only
the re-seed schedule differs: the JAX wide kernel re-seeds every
``even_chunks(n, chunk_t)`` samples, ``chunk_t`` 256 and no halving
(``sam.reseed_schedule(..., wide=True)``), so the two differ in the last
bits by design.

CUDA tensors launch ``csrc/sam_wide.cu`` (``sam_wide``, ``sam_wide_nb``:
``groups`` channels per thread block run their PLLs side by side), or raise;
CPU tensors run ``sweep_sam_wide_plain``. ``LAUNCHES`` and ``LAUNCHES_NB``
count the launches. ``groups`` is 2, 4 or 8, as the JAX bank's ``g_wide``;
on the card it sets how many channels share a block's serial stream and does
not change a bit of the result. Any channel count is taken (the JAX kernel
needs a multiple of groups*128 and the bank pads; here the last block masks
the channels past the end).
"""

from __future__ import annotations

from radiodsp_sdr_rx_tpu_torch.ops import sam as sam_ops
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import check_stream
from radiodsp_sdr_rx_tpu_torch.ops.sweep import chain_plain, launch_chain, sam_args

LAUNCHES = 0      # sam_wide
LAUNCHES_NB = 0   # sam_wide_nb
GROUPS = (2, 4, 8)


def _check(xr, groups):
    check_stream(xr)
    if groups not in GROUPS:
        raise ValueError(f"groups must be one of {GROUPS}, got {groups}")


def sweep_sam_wide_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, audio_tail,
                         env0, dc0, pll0, agc_release, agc_target, agc_max_gain,
                         agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0,
                         nb=False, nb_thresh_db=10.0, nb_tau=512.0, nb_avg0=None,
                         nb_mask0=None, groups=8, reseed=None, pll_bw_hz=100.0,
                         sample_rate=sam_ops.SAMPLE_RATE):
    """Plain PyTorch version of ``sweep_sam_wide`` (``groups`` checked, then
    without effect)."""
    _check(xr, groups)
    return chain_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, audio_tail,
                       env0, agc_release, agc_target, agc_max_gain, agc_enabled,
                       out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
                       nb_avg0, nb_mask0, dc0,
                       sam=sam_args(xr, pll0, reseed, pll_bw_hz, sample_rate, 256,
                                    wide=True))


def sweep_sam_wide(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, audio_tail, env0,
                   dc0, pll0, agc_release, agc_target, agc_max_gain, agc_enabled=True,
                   out_gain=1.0, in_gain=1.0, iq_balance=1.0, nb=False, nb_thresh_db=10.0,
                   nb_tau=512.0, nb_avg0=None, nb_mask0=None, groups=8, reseed=None,
                   pll_bw_hz=100.0, sample_rate=sam_ops.SAMPLE_RATE):
    """Whole SAM chain, ``groups`` channels per serial PLL stream; arguments
    and return as ``ops/sweep.sweep_sam_chain``; ``reseed`` None is one JAX
    call of the wrapper's default chunk_t, ``sam.reseed_schedule(n, 256,
    wide=True)``. CPU tensors run the plain version; CUDA tensors launch the
    kernel, or raise."""
    global LAUNCHES, LAUNCHES_NB
    if xr.device.type == "cpu":
        return sweep_sam_wide_plain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i,
                                    audio_tail, env0, dc0, pll0, agc_release, agc_target,
                                    agc_max_gain, agc_enabled, out_gain, in_gain,
                                    iq_balance, nb, nb_thresh_db, nb_tau, nb_avg0,
                                    nb_mask0, groups, reseed, pll_bw_hz, sample_rate)
    _check(xr, groups)
    outs = launch_chain(xr, xi, inc, phase0, w_sb, w_pbt, tail_r, tail_i, audio_tail,
                       env0, agc_release, agc_target, agc_max_gain, agc_enabled,
                        out_gain, in_gain, iq_balance, nb, nb_thresh_db, nb_tau,
                        nb_avg0, nb_mask0, dc0,
                        sam=sam_args(xr, pll0, reseed, pll_bw_hz, sample_rate, 256,
                                     wide=True),
                        groups=groups)
    if nb:
        LAUNCHES_NB += 1
    else:
        LAUNCHES += 1
    return outs
