"""The two operators of the SSB chain, built on the host in float64.

A numpy copy of ``ssb_demod_operator`` and ``pbt_operator`` from
``radiodsp_sdr_rx_tpu/ops/pallas_kernels.py``.
"""

from __future__ import annotations

import numpy as np

from radiodsp_sdr_rx_tpu_torch.ops.fir_design import overlap_save_matrix


def ssb_demod_operator(mask: np.ndarray, gain: float = 2.0) -> np.ndarray:
    """(512, 128) f32: ``[frames_re | frames_im] @ W == gain*Re(A @ frame)``.

    A is the collapsed overlap-save operator of ``mask``; gain=2 restores the
    SSB amplitude. Band-pass and SSB demod are one product.
    """
    a = overlap_save_matrix(mask)
    w_top = gain * a.real.T
    w_bot = -gain * a.imag.T
    return np.concatenate([w_top, w_bot], axis=0).astype(np.float32)


def pbt_operator(mask: np.ndarray) -> np.ndarray:
    """(256, 256) f32: ``audio_frames @ W == [L | R]`` of the reference PBT
    stage. With z = a(1+j): L = a @ (Ar - Ai).T, R = a @ (Ar + Ai).T."""
    a = overlap_save_matrix(mask)
    w_l = (a.real - a.imag).T
    w_r = (a.real + a.imag).T
    return np.concatenate([w_l, w_r], axis=1).astype(np.float32)
