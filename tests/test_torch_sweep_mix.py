"""K8, ``ops/sweep.sweep_mix_filter_demod``, on the CPU against the JAX
wrapper (``ops/pallas_sweep.py:147``) in Pallas interpret mode.

The port's plain version (what a CPU tensor runs) against the interpret-mode
TPU kernel at 8 channels: four 4,096-sample chunks' worth of samples at
chunk_t 2,048, 4,096 and 8,192, an odd chunk count (3 x 2,048) and a single
chunk (chunk_t = n), out_gain 1.0 and 1.1. Tolerance 2e-5, the JAX test's
own bound between this kernel and the stateless one
(tests/test_pallas_sweep.py:30): both are fp32 products of the same frames
and operator, summed in another order. The port does not tile, so its
output is the same bit for bit whatever chunk_t and block_c say; the
wrapper checks them as the JAX wrapper does and raises where the JAX grid
would leave rows unwritten.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.ops import fir_design as jax_fir
from radiodsp_sdr_rx_tpu.ops import pallas_kernels
from radiodsp_sdr_rx_tpu.ops.pallas_sweep import sweep_mix_filter_demod as jax_sweep_mix
from radiodsp_sdr_rx_tpu_torch.ops import fir_design, staged, sweep
from radiodsp_sdr_rx_tpu_torch.ops.operators import ssb_demod_operator

ATOL = 2e-5
FS = 44117.64706
C = 8


def _inputs(n, seed):
    rng = np.random.default_rng(seed)
    xr = (rng.standard_normal((C, n)) * 0.2).astype(np.float32)
    xi = (rng.standard_normal((C, n)) * 0.2).astype(np.float32)
    inc = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    ph = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.uint32)
    return xr, xi, inc, ph


def _w():
    return ssb_demod_operator(fir_design.design_filter_mask(300.0, 4000.0, FS))


def _port_args(xr, xi, inc, ph, w):
    return (torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(inc.astype(np.int64)),
            torch.from_numpy(ph.astype(np.int64)), torch.from_numpy(np.ascontiguousarray(w)))


def test_operator_bit_equal_to_jax():
    want = pallas_kernels.ssb_demod_operator(jax_fir.design_filter_mask(300.0, 4000.0, FS))
    assert np.array_equal(_w(), want) and _w().dtype == np.float32


@pytest.mark.parametrize("n, chunk_t, out_gain", [
    (4 * 4096, 2048, 1.0),
    (4 * 4096, 4096, 1.1),
    (4 * 4096, 8192, 1.0),
    (3 * 2048, 2048, 1.1),     # an odd chunk count
    (3 * 2048, 3 * 2048, 1.0),  # a single chunk
])
def test_plain_matches_jax_interpret(n, chunk_t, out_gain):
    xr, xi, inc, ph = _inputs(n, n + chunk_t)
    w = _w()
    want = np.asarray(jax_sweep_mix(xr, xi, inc, ph, w, out_gain=out_gain, chunk_t=chunk_t,
                                    interpret=True))
    got = sweep.sweep_mix_filter_demod(*_port_args(xr, xi, inc, ph, w), out_gain=out_gain,
                                       chunk_t=chunk_t)
    assert got.shape == (C, n) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)
    assert float(np.abs(want).max()) > 0.05     # the band carries signal
    # the result does not depend on the tiling hints
    for ct, bc in ((128, 8), (n, 1), (2048, 4)):
        again = sweep.sweep_mix_filter_demod(*_port_args(xr, xi, inc, ph, w),
                                             out_gain=out_gain, block_c=bc, chunk_t=ct)
        assert torch.equal(again, got)


def test_equals_mix_demod_with_a_zero_tail():
    """K8 is K2a's function from a stream start: the staged plain version
    with a zero tail and unit gains, times out_gain, bit for bit."""
    xr, xi, inc, ph = _inputs(4096, 3)
    args = _port_args(xr, xi, inc, ph, _w())
    got = sweep.sweep_mix_filter_demod(*args, out_gain=1.1)
    k2a = staged.fused_mix_filter_demod(*args, torch.zeros(C, 256)) * float(np.float32(1.1))
    assert torch.equal(got, k2a)


def test_cpu_tensors_never_launch():
    before = sweep.LAUNCHES_SWEEP_MIX
    sweep.sweep_mix_filter_demod(*_port_args(*_inputs(1024, 5), _w()))
    assert sweep.LAUNCHES_SWEEP_MIX == before


def _bad(**kw):
    xr, xi, inc, ph = _inputs(1024, 7)
    args = dict(zip(("xr", "xi", "inc", "phase0", "w"), _port_args(xr, xi, inc, ph, _w())))
    args.update(kw)
    return args


@pytest.mark.parametrize("kw", [
    dict(xr=torch.zeros(C, 200), xi=torch.zeros(C, 200)),        # n not a multiple of 128
    dict(xr=torch.zeros(6, 1024), xi=torch.zeros(6, 1024),       # C not a multiple of block_c
         inc=torch.zeros(6, dtype=torch.int64), phase0=torch.zeros(6, dtype=torch.int64)),
    dict(block_c=0),
    dict(chunk_t=64),                                            # _even_chunks' floor
    dict(xr=torch.zeros(C, 1024, dtype=torch.float64)),          # dtype
    dict(xi=torch.zeros(C, 512)),                                # shape
    dict(inc=torch.zeros(C, dtype=torch.int32)),                 # DDS words are int64
    dict(w=torch.zeros(256, 128)),                               # operator shape
])
def test_rejects_bad_arguments(kw):
    with pytest.raises(ValueError):
        sweep.sweep_mix_filter_demod(**_bad(**kw))
