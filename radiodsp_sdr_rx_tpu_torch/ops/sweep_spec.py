"""The SSB receive chain with spectral-subtraction NR in one kernel launch (K4).

Counterpart of ``radiodsp_sdr_rx_tpu/ops/pallas_sweep_spec.py``:
``sweep_spec_chain`` (:246), kernel ``_spec_chain_kernel`` (:46). Per channel,
the SSB chain of ``ops/sweep.sweep_full_chain`` (input gain / IQ balance, DDS
mix, band-pass + SSB demod, AGC, PBT -> [l | r]), then per 128-sample row the
spectral subtraction of ``ops/spectral_sub.py``:

  [prev_l | l | prev_r | r] (rows,512) @ W_fwd (512,512) -> [sr | si],
  mag = sqrt(sr^2 + si^2), floor_est = sum of mag over bins 30..180 *
  level*1.5/150, nf[j] = 0.35 nf[j-1] + 0.65 floor_est[j] across rows and
  segments, scale = 0.2 where mag <= max(nf, 0) else 1 - nf/max(mag, 1e-20),
  [sr*scale | si*scale] (rows,512) @ W_inv (512,256) -> [L | R], output gain,

in the plain version; the kernel computes the same two transforms as a
256-point FFT in the block (``csrc/sweep_chain.cuh``), which is why it takes
no operators but ``spectral_matmul_ops(256)``'s.

Carries: the RAW input's last block, the PBT tail, the AGC envelope, the
floor (unclamped) and the last post-PBT blocks of l and r.

``sweep_spec_chain`` launches the ssb instantiation of ``csrc/sweep_spec.cu``
without the blanker (through ``ops/lanes.launch``; the template,
``csrc/sweep_chain.cuh``, is the lanes kernel's) for CUDA tensors or raises;
for CPU tensors it runs ``sweep_spec_chain_plain``, the plain PyTorch
version the tests and ``chip_smoke.py`` hold the kernel to. ``LAUNCHES``
counts the launches. The JAX wrapper's TPU tiling and precision
knobs (``block_c``, ``chunk_t``, ``interpret``, ``precision``) have no
meaning here and are not taken; every product and the FFT are full fp32.
"""

from __future__ import annotations

from radiodsp_sdr_rx_tpu_torch.ops import lanes, sweep

LAUNCHES = 0   # K4, the ssb instantiation of csrc/sweep_spec.cu without the blanker


def lanes_args(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv, tail_r, tail_i,
          audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r, nr_level, agc_release,
          agc_target, agc_max_gain, agc_enabled, out_gain, in_gain, iq_balance) -> tuple:
    """The arguments of ``lanes.sweep_lanes_chain`` for the same segment."""
    return (xr, xi, inc, phase0, w_ssb, w_pbt, tail_r, tail_i, audio_tail, env0, agc_release,
            agc_target, agc_max_gain, agc_enabled, out_gain, in_gain, iq_balance, False, 10.0,
            512.0, None, None, None, None, None,
            sweep.SpecArgs(w_spec_fwd, w_spec_inv, nfloor0, spec_tail_l, spec_tail_r, nr_level))


def _returns(out: lanes.LanesOut) -> tuple:
    return (out.audio_l, out.audio_r, out.audio_tail, out.agc_env, out.nfloor, out.spec_tail_l,
            out.spec_tail_r)


def sweep_spec_chain_plain(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv,
                           tail_r, tail_i, audio_tail, env0, nfloor0, spec_tail_l,
                           spec_tail_r, nr_level, agc_release, agc_target, agc_max_gain,
                           agc_enabled=True, out_gain=1.0, in_gain=1.0, iq_balance=1.0):
    """Plain PyTorch version of ``sweep_spec_chain``: the plain SSB chain with
    the spectral stage after PBT (``sweep.chain_plain``), the floor as a
    doubling scan across its rows from the carry."""
    return _returns(lanes.sweep_lanes_chain_plain(*lanes_args(
        xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv, tail_r, tail_i, audio_tail,
        env0, nfloor0, spec_tail_l, spec_tail_r, nr_level, agc_release, agc_target,
        agc_max_gain, agc_enabled, out_gain, in_gain, iq_balance)))


def sweep_spec_chain(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv,
                     tail_r, tail_i, audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r,
                     nr_level, agc_release, agc_target, agc_max_gain, agc_enabled=True,
                     out_gain=1.0, in_gain=1.0, iq_balance=1.0):
    """Whole SSB + spectral-subtraction receive chain; arguments and returns
    as the JAX ``sweep_spec_chain``:

      xr, xi ... env0:  as ``ops/sweep.sweep_full_chain`` (RAW input, RAW tails)
      w_spec_fwd:       (512, 512) spectral_sub.spectral_matmul_ops forward DFT
      w_spec_inv:       (512, 256) its right-half inverse
      nfloor0:          (C,) noise-floor carry (zeros at stream start)
      spec_tail_l/r:    (C, 128) the previous post-PBT block of l and r
      nr_level:         subtraction strength (20/30/40/50 for SPEC1-4)

    Returns (audio_l, audio_r, audio_tail', env', nfloor', spec_tail_l',
    spec_tail_r'). CPU tensors run the plain version; CUDA tensors launch the
    kernel, or raise (a ValueError too for operators other than
    ``spectral_matmul_ops(256)``'s: the kernel computes the stage by FFT).
    """
    global LAUNCHES
    args = lanes_args(xr, xi, inc, phase0, w_ssb, w_pbt, w_spec_fwd, w_spec_inv, tail_r, tail_i,
                 audio_tail, env0, nfloor0, spec_tail_l, spec_tail_r, nr_level, agc_release,
                 agc_target, agc_max_gain, agc_enabled, out_gain, in_gain, iq_balance)
    if xr.device.type == "cpu":
        return _returns(lanes.sweep_lanes_chain_plain(*args))
    out = lanes.launch(*args)
    LAUNCHES += 1
    return _returns(out)
