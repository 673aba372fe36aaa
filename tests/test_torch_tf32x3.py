"""The tensor-core kernels' 3xTF32 product, modelled in PyTorch on the CPU.

K2b (``pbt``) and K1-nb (``sweep_chain_ssb_nb``) run their products in
``csrc/tc_gemm.cuh`` as three TF32 tensor-core passes: each fp32 operand
split into big = rna(x) and small = rna(x - big) (``cvt.rna.tf32.f32``), and
a @ b = small_a @ big_b + big_a @ small_b + big_a @ big_b in fp32.
``ops/tf32x3`` is that algebra; the kernels themselves run only on the card
(tests/test_torch_kernels_cuda.py). Held here:

- the split: big and small have 10 mantissa bits (the low 13 bits clear),
  big is x rounded to nearest with ties away from zero (against an exact
  float64 rounding), and big + small is x to 2^-22 relative;
- the model's product on the bank's own operators (``w_ssb`` 512 x 128,
  ``w_pbt`` 256 x 256) and on the frames the chain feeds them from the
  flagship scene (noise) and the blanker's impulse scene, against float64:
  <= 2e-6 of the largest output (the split keeps 22 bits of each operand;
  the fp32 sums over 256 or 512 terms add their own rounding);
- the model's staged PBT on one segment against the JAX ``pbt_filter``
  (Pallas interpret mode, a full fp32 product), 1e-5 as
  tests/test_torch_staged.py holds the plain fp32 version.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu.models.receiver import build_params
from radiodsp_sdr_rx_tpu.ops import pallas_kernels as jk
from radiodsp_sdr_rx_tpu_torch.models import config as tconfig
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedSSBBank
from radiodsp_sdr_rx_tpu_torch.ops import agc, sweep, tf32x3
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import BLOCK, mix

PRODUCT_TOL = 2e-6   # of max |y|, the model against float64
JAX_TOL = 1e-5


def _bits(x):
    return x.contiguous().view(torch.int32).numpy().astype(np.int64) & 0xFFFFFFFF


def _rna64(x):
    """x (float32 numpy, normal numbers) rounded to 11 significant bits in
    float64, to nearest with ties away from zero."""
    x = x.astype(np.float64)
    ulp = np.exp2(np.floor(np.log2(np.abs(x))) - 10)
    return np.sign(x) * np.floor(np.abs(x) / ulp + 0.5) * ulp


@pytest.mark.parametrize("scale", [1.0, 1e-30, 1e30, 3e-5])
def test_split_keeps_ten_mantissa_bits(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    x = (rng.standard_normal(4096) * scale).astype(np.float32)
    big, small = tf32x3.split_tf32(torch.from_numpy(x))
    assert not (_bits(big) & 0x1FFF).any() and not (_bits(small) & 0x1FFF).any()
    assert np.array_equal(big.numpy().astype(np.float64), _rna64(x))
    err = np.abs(big.numpy().astype(np.float64) + small.numpy() - x)
    assert (err <= np.abs(x.astype(np.float64)) * 2.0**-22).all()


def test_split_rounds_ties_away_from_zero():
    one = 1.0 + 2.0**-10                       # the TF32 number after 1
    x = torch.tensor([1.0 + 2.0**-11, -(1.0 + 2.0**-11), 1.0 + 2.0**-11 - 2.0**-20,
                      1.0 + 2.0**-11 + 2.0**-20, float("inf"), 0.0], dtype=torch.float32)
    big = tf32x3.round_tf32(x).tolist()
    assert big == [one, -one, 1.0, one, float("inf"), 0.0]


def _scene(kind, c, n, seed):
    """(the sweep bank on the CPU, its chain arguments for one segment): the
    flagship's noise (bench.py's USB bank) or the blanker's impulse scene
    (chip_smoke.py's nb_scene), with the average warm-started."""
    cfg = tconfig.ReceiverConfig(mode=tconfig.DemodMode.USB, vfo_freq=7_200_000.0,
                                 capture_center_freq=7_190_000.0, agc=tconfig.AGCMode.MEDIUM,
                                 noise_blanker=kind == "blanker")
    bank = FusedSSBBank(cfg, [7_190_000.0 + 1_000.0 * k for k in range(c)], device="cpu")
    rng = np.random.default_rng(seed)
    xr, xi = (torch.from_numpy(rng.standard_normal((c, n)).astype(np.float32) * 0.1)
              for _ in range(2))
    state = bank.init_state()
    if kind == "blanker":
        mag = torch.hypot(xr, xi)
        f = (2.2 * mag.mean() / mag.clamp(min=1e-12)).clamp(max=1.0)
        xr, xi = xr * f, xi * f
        for pos in (500, 1733, n // 2 + 7, n - 3, n - 1):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
        state = state._replace(nb_avg=torch.full((c,), float(torch.hypot(xr, xi).mean())))
    return bank, bank.chain_args(xr, xi, state)


def _frames(kind):
    """The two products' frames as the chain builds them on one segment:
    [prev_r | cur_r | prev_i | cur_i] of the [blanked,] mixed stream
    (rows, 512) and [prev | cur] of the AGC'd audio (rows, 256)."""
    c, n = 4, 8192
    bank, (xr, xi, inc, phase0, w_ssb, w_pbt, *rest) = _scene(kind, c, n, len(kind))
    if kind == "blanker":
        xr, xi, *_ = sweep._blank(xr, xi, rest[14], rest[12], rest[13])
    br, bi = mix(xr, xi, phase0, inc, torch.arange(n))
    br, bi = br.view(c, -1, BLOCK), bi.view(c, -1, BLOCK)
    zero = torch.zeros(c, 1, BLOCK)
    band = torch.cat([torch.cat([zero, br[:, :-1]], 1), br,
                      torch.cat([zero, bi[:, :-1]], 1), bi], -1).view(-1, 4 * BLOCK)
    audio = torch.matmul(band.double(), w_ssb.double()).float().view(c, n)
    audio = agc.agc_run(audio, bank.agc_params, torch.full((c,), 1e-6))[0].view(c, -1, BLOCK)
    pbt = torch.cat([torch.cat([zero, audio[:, :-1]], 1), audio], -1).view(-1, 2 * BLOCK)
    return {"w_ssb": (band, w_ssb), "w_pbt": (pbt, w_pbt)}


@pytest.mark.parametrize("operator", ["w_ssb", "w_pbt"])
@pytest.mark.parametrize("kind", ["flagship", "blanker"])
def test_model_product_matches_float64_on_the_bank_operators(kind, operator):
    a, w = _frames(kind)[operator]
    want = torch.matmul(a.double(), w.double())
    got = tf32x3.matmul_3xtf32(a, w)
    assert got.dtype == torch.float32 and got.shape == want.shape
    err = float((got.double() - want).abs().max())
    assert err <= PRODUCT_TOL * float(want.abs().max())


@pytest.mark.parametrize("out_gain, warm_tail", [(1.0, False), (0.5, True)])
def test_model_pbt_matches_jax_interpret(out_gain, warm_tail):
    c, n = 8, 4096
    p = build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM))
    rng = np.random.default_rng(20 + int(warm_tail))
    tail = (rng.standard_normal((c, BLOCK)).astype(np.float32) if warm_tail
            else np.zeros((c, BLOCK), np.float32))
    audio = rng.standard_normal((c, n)).astype(np.float32)
    want = jk.pbt_filter(audio, p.w_pbt, tail=tail, block_t=2048, interpret=True)
    a = torch.from_numpy(audio).view(c, -1, BLOCK)
    frames = torch.cat([torch.cat([torch.from_numpy(tail)[:, None], a[:, :-1]], 1), a], -1)
    lr = tf32x3.matmul_3xtf32(frames.view(-1, 2 * BLOCK), torch.from_numpy(
        np.ascontiguousarray(p.w_pbt))).view(c, n // BLOCK, 2 * BLOCK) * float(np.float32(out_gain))
    for got, w in zip((lr[..., :BLOCK], lr[..., BLOCK:]), want):
        np.testing.assert_allclose(got.reshape(c, n).numpy(), np.asarray(w) * np.float32(out_gain),
                                   atol=JAX_TOL, rtol=0)
