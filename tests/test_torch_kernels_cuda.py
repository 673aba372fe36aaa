"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs an NVIDIA card and nvcc; without them each skips (the
``cuda_device`` fixture decides at run time). On the card:
``python -m pytest tests/test_torch_kernels_cuda.py -q``.
Tolerance 1e-4, as in chip_smoke.py: both are fp32 (TF32 off), the sums are
taken in another order, and the AGC gain of up to 316 amplifies rounding.
The LMS kernel is held to 2e-4, the JAX twin bound (tests/test_pallas_lms.py:
35): its 96-tap sums run in another order and the adaptation carries that.
The NR bank's staged routes are held to the port's ReceiverBank at 2e-3
(docs/CHIP_PARITY.md). The SAM kernels (K5 sam_pll, K6 sweep_chain_sam and
sweep_chain_sam_nb, K7 sam_wide and sam_wide_nb) run on a locked-carrier
scene, the PLL being chaotic on noise, at 1e-4, with the plain PLL's
per-sample loop kept to a few thousand samples (K7 and SAM + spectral, whose
walk runs a chunk ahead of the rest of their chain, also on segments whose
last chunk is partial, SAM + spectral frame by frame); the PLL's pieces through
csrc/sam.cu's probe: the explicit divide bit for bit against IEEE division
where the quotient is at least 2^-126 (tiny numerators included), within
2^-149 below, the atan2 within
ATAN2_ULPS of the plain one. The
NR instantiations of the lanes kernel (ops/lanes.py: LMS denoise and notch,
spectral NR, after each demod, with and without the blanker) run on the
same locked scenes, at 2e-4 with an LMS stage and 1e-4 with the spectral
one; the six spectral routes (K4 and K6's five), whose kernels run the
stage as an in-block FFT, also frame by frame against the plain chain's
dense DFT products over two threaded segments with a partial last chunk (a
frame with a bin near the floor to 1e-4 plus the flips' size). K8
(``sweep.sweep_mix_filter_demod``, kernel sweep_mix_demod) is held to its
plain version at 1e-4, to K2a with a zero tail bit for bit, across chunk_t
bit for bit. The single-channel ``Receiver`` on the card is held to the same
Receiver on the CPU (1e-4, LMS 2e-4), to the committed goldens (1e-4 x
their peak) and to the CPU's sequence of I2S repairs. K9 (``ring_shift``,
parallel/halo.py) equals its plain copies bit for bit, one launch per
exchange on one card (every ring of the list in it), one per source card
across cards (skipped with fewer than two), and the time-sharded chain's
kernel halo equals its ppermute halo bit for bit.
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu_torch.models.config import AGCMode, DemodMode, NRMode, ReceiverConfig
from radiodsp_sdr_rx_tpu_torch.models.fused import (
    FusedAMBank, FusedNRBank, FusedSAMBank, FusedSSBBank)
from radiodsp_sdr_rx_tpu_torch.models.receiver import Receiver, ReceiverBank
from radiodsp_sdr_rx_tpu_torch.ops import (
    agc, lanes, lms, lms_bank, sam, sam_wide, staged, sweep, sweep_spec)

pytestmark = pytest.mark.cuda
ATOL = 1e-4
LMS_ATOL = 2e-4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _bank(agc_mode, channels, device=None, backend="sweep", noise_blanker=False):
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=agc_mode,
                         noise_blanker=noise_blanker)
    return FusedSSBBank(cfg, [7_190_000.0 + 1_000.0 * k for k in range(channels)],
                        backend=backend, device=device)


def _close(got, ref):
    for g, r in zip(got, ref):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=ATOL, rtol=0)


SHAPES = [
    (8, 8192, AGCMode.MEDIUM),   # one whole 64-row chunk
    (3, 8576, AGCMode.FAST),     # a partial last chunk (67 rows)
    (4, 256, AGCMode.OFF),       # two rows, AGC off
]


@pytest.mark.parametrize("channels, n, agc", SHAPES)
def test_kernel_matches_plain_over_two_segments(cuda_device, channels, n, agc):
    bank = _bank(agc, channels, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n)
    state = bank.init_state()
    for _ in range(2):
        xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xr[:, n // 3:n // 3 + 100] *= 30.0
        ref = sweep.sweep_full_chain_plain(*bank.chain_args(xr, xi, state))
        out, state = bank.process_planar(xr, xi, state)
        got = (out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env)
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=ATOL, rtol=0)


def test_default_device_launches_once_per_segment(cuda_device):
    bank = _bank(AGCMode.MEDIUM, 8)
    assert bank.device.type == "cuda"
    state = bank.init_state()
    x = torch.zeros((8, 1024), device=cuda_device)
    before = sweep.LAUNCHES
    for _ in range(3):
        _, state = bank.process_planar(x, x, state)
    torch.cuda.synchronize()
    assert sweep.LAUNCHES == before + 3


def test_plain_versions_restore_tf32_setting(cuda_device):
    """The plain versions switch TF32 off for their products only."""
    bank = _bank(AGCMode.MEDIUM, 2, cuda_device)
    x = torch.zeros((2, 256), device=cuda_device)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        sweep.sweep_full_chain_plain(*bank.chain_args(x, x, bank.init_state()))
        staged.pbt_filter_plain(x, bank.params.w_pbt, torch.zeros((2, 128), device=cuda_device))
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


def test_kernel_rejects_strided_input(cuda_device):
    bank = _bank(AGCMode.MEDIUM, 4, cuda_device)
    x = torch.zeros((4, 512), device=cuda_device)
    args = list(bank.chain_args(x, x, bank.init_state()))
    args[0] = torch.zeros((4, 1024), device=cuda_device)[:, ::2]
    with pytest.raises(ValueError, match="contiguous"):
        sweep.sweep_full_chain(*args)


@pytest.mark.parametrize("channels, n, agc_mode", SHAPES)
def test_staged_kernels_match_plain_over_two_segments(cuda_device, channels, n, agc_mode):
    """mix_demod and pbt each against its plain version on the same inputs, and
    the staged bank (2 launches per segment) against the plain chain."""
    bank = _bank(agc_mode, channels, cuda_device, backend="staged")
    gen = torch.Generator(device=cuda_device).manual_seed(n + 1)
    state = bank.init_state()
    for _ in range(2):
        xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xr[:, n // 3:n // 3 + 100] *= 30.0
        args = bank.mix_demod_args(xr, xi, state)
        audio = staged.fused_mix_filter_demod_plain(*args)
        _close([staged.fused_mix_filter_demod(*args)], [audio])
        audio_g, env = agc.agc_run(audio, bank.agc_params, state.agc_env)
        ref = staged.pbt_filter_plain(*bank.pbt_args(audio_g, state))
        _close(staged.pbt_filter(*bank.pbt_args(audio_g, state)), ref)
        before = (staged.LAUNCHES_MIX_DEMOD, staged.LAUNCHES_PBT)
        out, state = bank.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        assert (staged.LAUNCHES_MIX_DEMOD, staged.LAUNCHES_PBT) == (before[0] + 1, before[1] + 1)
        _close((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env),
               ref + (audio_g[:, -128:], env))


@pytest.mark.parametrize("channels, n, agc_mode", SHAPES)
def test_nb_kernel_matches_plain_over_two_segments(cuda_device, channels, n, agc_mode):
    """The blanker on the decisive scene (clipped noise, impulses far above the
    threshold, the average warm-started), with an impulse on each segment's
    last sample so that its keep mask carries into the next segment."""
    bank = _bank(agc_mode, channels, cuda_device, noise_blanker=True)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 2)
    xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.05
    xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.05
    mag = torch.hypot(xr, xi)
    f = (2.2 * mag.mean() / mag.clamp(min=1e-12)).clamp(max=1.0)
    xr, xi = xr * f, xi * f
    for pos in sorted({n // 5, n // 2 + 3, n - 1}):
        xr[:, pos] = 8.0
        xi[:, pos] = 8.0
    state = bank.init_state()._replace(
        nb_avg=torch.full((channels,), float(torch.hypot(xr, xi).mean()), device=cuda_device))
    for _ in range(2):
        ref = sweep.sweep_full_chain_plain(*bank.chain_args(xr, xi, state))
        before = sweep.LAUNCHES_NB
        out, state = bank.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        assert sweep.LAUNCHES_NB == before + 1
        _close((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env,
                state.nb_avg, state.nb_mask), ref)
        assert float(state.nb_mask[:, -1].max()) == 0.0


def _impulse_scene(channels, n, gen, device):
    """Clipped noise with impulses of 8(1+1j), one on the last sample, and the
    mean magnitude to warm-start the blanker's average."""
    xr = torch.randn((channels, n), generator=gen, device=device) * 0.05
    xi = torch.randn((channels, n), generator=gen, device=device) * 0.05
    mag = torch.hypot(xr, xi)
    f = (2.2 * mag.mean() / mag.clamp(min=1e-12)).clamp(max=1.0)
    xr, xi = xr * f, xi * f
    for pos in sorted({n // 5, n // 2 + 3, n - 1}):
        xr[:, pos] = 8.0
        xi[:, pos] = 8.0
    return xr, xi, float(torch.hypot(xr, xi).mean())


@pytest.mark.parametrize("nb", [False, True])
@pytest.mark.parametrize("channels, n, agc_mode", SHAPES)
def test_am_kernel_matches_plain_over_two_segments(cuda_device, channels, n, agc_mode, nb):
    """K1-am (and K1-am-nb on the impulse scene) against sweep_am_chain_plain,
    every output and carry, the DC blocker's included."""
    cfg = ReceiverConfig(mode=DemodMode.AM, vfo_freq=7_060_000.0,
                         capture_center_freq=7_050_000.0, agc=agc_mode, noise_blanker=nb)
    bank = FusedAMBank(cfg, [7_050_000.0 + 1_000.0 * k for k in range(channels)],
                       device=cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 3)
    state = bank.init_state()
    if nb:
        xr, xi, mean_mag = _impulse_scene(channels, n, gen, cuda_device)
        state = state._replace(nb_avg=torch.full((channels,), mean_mag, device=cuda_device))
    for _ in range(2):
        if not nb:
            xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1 + 0.2
            xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
            xr[:, n // 3:n // 3 + 100] *= 30.0
        ref = sweep.sweep_am_chain_plain(*bank.chain_args(xr, xi, state))
        before = (sweep.LAUNCHES_AM, sweep.LAUNCHES_AM_NB)
        out, state = bank.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        assert (sweep.LAUNCHES_AM, sweep.LAUNCHES_AM_NB) == (before[0] + (not nb), before[1] + nb)
        got = (out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env, state.am_dc)
        _close(got + ((state.nb_avg, state.nb_mask) if nb else ()), ref)
        if nb:
            assert float(state.nb_mask[:, -1].max()) == 0.0


@pytest.mark.parametrize("mode", ["denoise", "notch"])
@pytest.mark.parametrize("channels, n", [(8, 4096), (5, 1000), (3, 100), (1, 16384),
                                         (128, 1 << 19)])
def test_lms_kernel_matches_plain_over_two_segments(cuda_device, channels, n, mode):
    """K3 against lms_nr_run_bank_plain (the same grouped algebra, group and
    rebase schedule), first=True into the first segment (the quirk) and False
    after, on tones in noise: n not a multiple of the group (a short last
    group) or of 32, shorter than the delay line, one channel at the
    Receiver's 16,384-sample block, and whole 128 x 2^19 segments (the
    drift a prefix cannot show)."""
    gen = torch.Generator(device=cuda_device).manual_seed(n + len(mode))
    t = torch.arange(n, device=cuda_device, dtype=torch.float32)
    f = torch.rand((channels, 1), generator=gen, device=cuda_device) * 0.2 + 0.01
    mu = lms.lms_mu_from_strength(30)
    state = lms.lms_nr_init(channels, device=cuda_device)
    for seg in range(2):
        x = (0.3 * torch.sin(2 * torch.pi * f * (t + seg * n))
             + 0.1 * torch.randn((channels, n), generator=gen, device=cuda_device))
        args = (x, state.weights, state.window, state.delay, state.first, mu, mode)
        ref = lms_bank.lms_nr_run_bank_plain(*args)
        before = lms_bank.LAUNCHES
        got = lms_bank.lms_nr_run_bank(*args)
        torch.cuda.synchronize()
        assert lms_bank.LAUNCHES == before + 1
        for g, r in zip(got, ref):
            assert bool(torch.isfinite(g).all())
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=LMS_ATOL, rtol=0)
        assert torch.equal(got[2], ref[2]) and torch.equal(got[3], ref[3])  # input copies
        _, state = lms.lms_nr_run(x, state, mu, mode)


@pytest.mark.parametrize("nr", [NRMode.NOTCH, NRMode.DNR2])
def test_receiver_bank_launches_one_lms_per_segment(cuda_device, nr):
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, nr=nr)
    bank = ReceiverBank(cfg, [7_190_000.0 + 1_000.0 * k for k in range(4)], backend="batched")
    assert bank.device.type == "cuda"
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    state = bank.init_state()
    before = lms_bank.LAUNCHES
    for _ in range(3):
        x = torch.randn((4, 2048), generator=gen, device=cuda_device) * 0.1
        out, state = bank.process_planar(x, x, state)
    torch.cuda.synchronize()
    assert lms_bank.LAUNCHES == before + 3
    assert bool(torch.isfinite(out["audio_l"]).all()) and not bool(state.lms.first.any())


def _nr_bank(nr, channels, fold=True, agc_mode=AGCMode.MEDIUM, **extra):
    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                         capture_center_freq=7_190_000.0, agc=agc_mode, nr=nr, **extra)
    return FusedNRBank(cfg, [7_190_000.0 + 1_000.0 * k for k in range(channels)], fold=fold)


@pytest.mark.parametrize("gains", [{}, {"input_gain": 0.7, "iq_gain_balance": 1.02}])
@pytest.mark.parametrize("channels, n, agc_mode", SHAPES)
def test_spec_kernel_matches_plain_over_two_segments(cuda_device, channels, n, agc_mode, gains):
    """K4 against sweep_spec_chain_plain, all seven outputs, over two threaded
    segments (the floor, the l/r carries and the raw tail carry into the
    second)."""
    bank = _nr_bank(NRMode.SPEC2, channels, agc_mode=agc_mode, **gains)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 4)
    state = bank.init_state()
    for _ in range(2):
        xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
        xr[:, n // 3:n // 3 + 100] *= 30.0
        ref = sweep_spec.sweep_spec_chain_plain(*bank.spec_args(xr, xi, state))
        before = sweep_spec.LAUNCHES
        out, state = bank.process_planar(xr, xi, state)
        torch.cuda.synchronize()
        assert sweep_spec.LAUNCHES == before + 1
        _close((out["audio_l"], out["audio_r"], state.audio_tail, state.agc_env, state.nfloor,
                state.spec_tail_l, state.spec_tail_r), ref)
        assert float(state.nfloor.min()) > 0.0


@pytest.mark.parametrize("channels, n, agc_mode", SHAPES)
def test_mono_kernel_matches_plain(cuda_device, channels, n, agc_mode):
    """sweep_chain_ssb_mono (emit_r=False): L as the plain version's, R None,
    and L bit for bit the L of the stereo kernel."""
    bank = _bank(agc_mode, channels, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(n + 5)
    xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
    xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
    args = bank.chain_args(xr, xi, bank.init_state())
    before = (sweep.LAUNCHES, sweep.LAUNCHES_MONO)
    got = sweep.sweep_full_chain(*args, emit_r=False)
    stereo = sweep.sweep_full_chain(*args)
    torch.cuda.synchronize()
    assert (sweep.LAUNCHES, sweep.LAUNCHES_MONO) == (before[0] + 1, before[1] + 1)
    assert got[1] is None
    ref = sweep.sweep_full_chain_plain(*args, emit_r=False)
    assert ref[1] is None
    _close(got[:1] + got[2:], ref[:1] + ref[2:])
    assert torch.equal(got[0], stereo[0])


@pytest.mark.parametrize("nr, launches", [
    (NRMode.DNR2, {"mono": 1, "lms": 1}),
    (NRMode.NOTCH, {"mix_demod": 1, "lms": 1, "pbt": 1}),
    (NRMode.SPEC2, {"ssb": 1}),
])
def test_nr_bank_staged_routes(cuda_device, nr, launches):
    """FusedNRBank(fold=False): each route's kernels, one launch each per
    segment and no other, and the port's ReceiverBank within 2e-3."""
    bank = _nr_bank(nr, 8, fold=False)
    ref_bank = ReceiverBank(bank.config, [7_190_000.0 + 1_000.0 * k for k in range(8)])
    gen = torch.Generator(device=cuda_device).manual_seed(6)
    st, st_ref = bank.init_state(), ref_bank.init_state()

    def counts():
        return {"ssb": sweep.LAUNCHES, "mono": sweep.LAUNCHES_MONO,
                "mix_demod": staged.LAUNCHES_MIX_DEMOD, "pbt": staged.LAUNCHES_PBT,
                "lms": lms_bank.LAUNCHES, "spec": sweep_spec.LAUNCHES}

    for _ in range(2):
        xr = torch.randn((8, 4096), generator=gen, device=cuda_device) * 0.1
        xi = torch.randn((8, 4096), generator=gen, device=cuda_device) * 0.1
        before = counts()
        out, st = bank.process_planar(xr, xi, st)
        torch.cuda.synchronize()
        after = counts()
        assert {k: after[k] - before[k] for k in after} == {k: launches.get(k, 0) for k in after}
        want, st_ref = ref_bank.process_planar(xr, xi, st_ref)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(out[key].cpu().numpy(), want[key].cpu().numpy(),
                                       atol=2e-3, rtol=0)


SAM_CENTER = 7_050_000.0
FS = 44117.64706


def _locked(channels, n, gen, device, spacing=1_000.0, baseband=False):
    """Row k an AM carrier (depth 0.4, a 400-500 Hz tone) within 50 Hz of
    channel k's mix (k*spacing; 0 for baseband), plus 0.02-sigma noise."""
    t = torch.arange(n, device=device, dtype=torch.float64) / FS
    k = torch.arange(channels, device=device, dtype=torch.float64)[:, None]
    r = torch.rand((channels, 3), generator=gen, device=device, dtype=torch.float64)
    f = (0.0 if baseband else k * spacing) + (r[:, :1] - 0.5) * 100.0
    env = 1.0 + 0.4 * torch.sin(2 * torch.pi * (400.0 + 100.0 * r[:, 1:2]) * t)
    ang = 2 * torch.pi * f * t + 2 * torch.pi * r[:, 2:3]
    noise = torch.randn((2, channels, n), generator=gen, device=device) * 0.02
    return ((env * torch.cos(ang)).float() + noise[0]).contiguous(), \
        ((env * torch.sin(ang)).float() + noise[1]).contiguous()


def _phase_close(got, ref):
    d = (got - ref).abs() % (2 * torch.pi)
    assert float(torch.minimum(d, 2 * torch.pi - d).max()) <= ATOL


@pytest.mark.parametrize("channels, n, chunk", [(8, 2048, 4096), (37, 1000, 4096),
                                                (130, 2048, 512)])
def test_sam_pll_kernel_matches_plain_over_two_segments(cuda_device, channels, n, chunk):
    """K5 against sam_pll_run_plain: vr, phase, freq; a ragged last tile
    (n = 1000) and a partial last block of 32 channels (37, 130) included."""
    gen = torch.Generator(device=cuda_device).manual_seed(channels)
    zr, zi = _locked(channels, 2 * n, gen, cuda_device, baseband=True)
    ph = torch.rand(channels, generator=gen, device=cuda_device) * 6.28
    fr = torch.zeros(channels, device=cuda_device)
    for seg in range(2):
        args = (zr[:, seg * n:(seg + 1) * n].contiguous(), zi[:, seg * n:(seg + 1) * n].contiguous(),
                ph, fr, 100.0, FS, chunk)
        ref = sam.sam_pll_run_plain(*args)
        before = sam.LAUNCHES
        got = sam.sam_pll_run(*args)
        torch.cuda.synchronize()
        assert sam.LAUNCHES == before + 1
        _close((got[0], got[2]), (ref[0], ref[2]))
        _phase_close(got[1], ref[1])
        ph, fr = got[1], got[2]


def test_probe_divide_equals_ieee_division(cuda_device):
    """div_rn, the PLL's divide without the slow-path branch, against numpy's
    float32 division on the CPU over the PLL's operands (sam.probe_operands:
    signed zeros, subnormal numerators, quotients near the subnormal grid's
    midpoints): bit for bit wherever the quotient is at least 2^-126, within
    2^-149 below, the signed zero of a zero numerator kept
    (csrc/sam_pll.cuh's contract); the compiler's `/` in the
    same kernel and torch's division on the card bit for bit everywhere. No
    launch is counted."""
    num, den = sam.probe_operands(29)
    a, b = torch.from_numpy(num).to(cuda_device), torch.from_numpy(den).to(cuda_device)
    before = sam.LAUNCHES
    q, q_ref, _ = sam.probe(a, b)
    torch.cuda.synchronize()
    assert sam.LAUNCHES == before
    want = num / den
    normal = np.abs(want) >= np.float32(2.0 ** -126)
    for got in (q_ref, a / b):
        np.testing.assert_array_equal(got.cpu().numpy().view(np.int32), want.view(np.int32))
    got = q.cpu().numpy()
    np.testing.assert_array_equal(got[normal].view(np.int32), want[normal].view(np.int32))
    assert float(np.abs(got[~normal].astype(np.float64) - want[~normal]).max()) <= 2.0 ** -149
    zero = num == 0
    assert np.signbit(num[zero]).any() and (~np.signbit(num[zero])).any()
    np.testing.assert_array_equal(np.signbit(got[zero]), np.signbit(want[zero]))
    assert (~normal).sum() > 100_000


ATAN2_ULPS = 4   # the kernel's FMAs and the plain version's separate products


def test_probe_atan2_matches_plain(cuda_device):
    """The device atan2_poly against ops/sam.atan2_poly on the CPU: the same
    algebra, the kernel's products fused into FMAs, so within ATAN2_ULPS ulps
    of the plain result (and its divide equal to the plain's). Inputs: normal
    pairs, the axes and the origin, the octant boundaries |y| = |x| and
    |y| = tan(pi/8) |x|, and a locked PLL's (vr, vi), vi small."""
    rng = np.random.default_rng(31)
    y = rng.standard_normal(1 << 18).astype(np.float32)
    x = rng.standard_normal(1 << 18).astype(np.float32)
    t = np.float32(0.41421356)
    y[:8], x[:8] = [0, 1, -1, 0, 0, 1, -1, 0], [0, 0, 0, 1, -1, 1, -1, -1]
    y[8:4096] = x[8:4096] * rng.choice([-1, 1], 4088)
    y[4096:8192] = x[4096:8192] * t * rng.choice([-1, 1], 4096)
    y[8192:16384] *= 1e-3
    a, b = torch.from_numpy(y).to(cuda_device), torch.from_numpy(x).to(cuda_device)
    got = sam.probe(a, b)[2].cpu().numpy()
    want = sam.atan2_poly(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    ulps = np.abs(got.astype(np.float64) - want) / np.spacing(np.abs(want).astype(np.float32))
    assert float(ulps.max()) <= ATAN2_ULPS
    np.testing.assert_allclose(got, np.arctan2(y, x), atol=1e-6, rtol=0)


def _sam_bank(channels, agc_mode=AGCMode.MEDIUM, **kw):
    nb = kw.pop("noise_blanker", False)
    cfg = ReceiverConfig(mode=DemodMode.SAM, vfo_freq=7_060_000.0,
                         capture_center_freq=SAM_CENTER, agc=agc_mode, noise_blanker=nb)
    return FusedSAMBank(cfg, [SAM_CENTER + 1_000.0 * k for k in range(channels)], **kw)


def _sam_counts():
    return (sam.LAUNCHES, staged.LAUNCHES_PBT, sweep.LAUNCHES_SAM, sweep.LAUNCHES_SAM_NB,
            sam_wide.LAUNCHES, sam_wide.LAUNCHES_NB)


SAM_SHAPES = [
    (8, 2048, AGCMode.MEDIUM),   # a partial 64-row chunk
    (3, 2176, AGCMode.FAST),     # 17 rows, re-seeded every 128 samples
    (4, 256, AGCMode.OFF),       # two rows, AGC off
]


SAM_CASES = ([(None, nb, *shape) for nb in (False, True) for shape in SAM_SHAPES]
             + [(8, False, *SAM_SHAPES[0]), (8, True, *SAM_SHAPES[1]),
                (4, False, *SAM_SHAPES[1]), (2, True, *SAM_SHAPES[2]),
                (2, False, 5, 2048, AGCMode.MEDIUM)])


@pytest.mark.parametrize("groups, nb, channels, n, agc_mode", SAM_CASES)
def test_sam_chain_kernels_match_plain_over_two_segments(cuda_device, groups, nb, channels, n,
                                                         agc_mode):
    """K6 (groups None) and K7 (2, 4, 8 channels a block; the channel counts
    are not multiples of every G) against the plain chain on the route's
    re-seed schedule, every output and carry, over two threaded segments; the
    blanker on impulses far above the threshold, one on each segment's last
    sample."""
    bank = _sam_bank(channels, agc_mode, noise_blanker=nb)
    gen = torch.Generator(device=cuda_device).manual_seed(n + channels)
    xr, xi = _locked(channels, n, gen, cuda_device)
    if nb:
        for pos in sorted({n // 5, n // 2 + 3, n - 1}):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
    state = bank.init_state()._replace(
        nb_avg=torch.full((channels,), float(torch.hypot(xr, xi).mean()), device=cuda_device))
    for _ in range(2):
        args = bank.chain_args(xr, xi, state)
        if groups is None:
            ref = sweep.sweep_sam_chain_plain(*args)
            before = (sweep.LAUNCHES_SAM, sweep.LAUNCHES_SAM_NB)
            got = sweep.sweep_sam_chain(*args)
            torch.cuda.synchronize()
            assert (sweep.LAUNCHES_SAM, sweep.LAUNCHES_SAM_NB) == (before[0] + (not nb),
                                                                  before[1] + nb)
        else:
            wide = args[:24] + (groups, sam.reseed_schedule(n, 256, wide=True)) + args[-2:]
            ref = sam_wide.sweep_sam_wide_plain(*wide)
            before = (sam_wide.LAUNCHES, sam_wide.LAUNCHES_NB)
            got = sam_wide.sweep_sam_wide(*wide)
            torch.cuda.synchronize()
            assert (sam_wide.LAUNCHES, sam_wide.LAUNCHES_NB) == (before[0] + (not nb),
                                                                before[1] + nb)
        assert len(got) == len(ref) == (8 if nb else 6)
        _close(got[:5] + got[6:], ref[:5] + ref[6:])
        _close(got[5][1:], ref[5][1:])
        _phase_close(got[5][0], ref[5][0])
        if nb:
            assert float(got[7][:, -1].max()) == 0.0
        out, state = bank.process_planar(xr, xi, state)
        if groups is None:   # the bank's route is the kernel just launched
            assert torch.equal(out["audio_l"], got[0])


# K7 walks its PLLs a chunk ahead of the rest of its chain: 35 rows a
# channel leave a last chunk of 3 rows at every G (R = 64/G rows a channel
# a chunk), and the channel counts are no multiple of G
@pytest.mark.parametrize("nb", [False, True])
@pytest.mark.parametrize("groups, channels", [(2, 5), (4, 7), (8, 13)])
def test_sam_wide_pipeline_matches_plain_over_two_segments(cuda_device, groups, channels, nb):
    """K7 against the plain chain on its re-seed schedule over two threaded
    segments whose last chunk is partial (fewer than R rows of each channel),
    every output and carry; the blanker on impulses far above its threshold,
    one on each segment's last sample."""
    n = 35 * 128
    assert (n // 128) % (64 // groups) == 3 and channels % groups
    bank = _sam_bank(channels, AGCMode.FAST, noise_blanker=nb)
    gen = torch.Generator(device=cuda_device).manual_seed(100 * groups + channels)
    xr, xi = _locked(channels, n, gen, cuda_device)
    if nb:
        for pos in (n // 5, n // 2 + 3, n - 1):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
    state = bank.init_state()._replace(
        nb_avg=torch.full((channels,), float(torch.hypot(xr, xi).mean()), device=cuda_device))
    for _ in range(2):
        args = bank.chain_args(xr, xi, state)
        wide = args[:24] + (groups, sam.reseed_schedule(n, 256, wide=True)) + args[-2:]
        ref = sam_wide.sweep_sam_wide_plain(*wide)
        before = (sam_wide.LAUNCHES, sam_wide.LAUNCHES_NB)
        got = sam_wide.sweep_sam_wide(*wide)
        torch.cuda.synchronize()
        assert (sam_wide.LAUNCHES, sam_wide.LAUNCHES_NB) == (before[0] + (not nb),
                                                            before[1] + nb)
        assert len(got) == len(ref) == (8 if nb else 6)
        _close(got[:5] + got[6:], ref[:5] + ref[6:])
        _close(got[5][1:], ref[5][1:])
        _phase_close(got[5][0], ref[5][0])
        if nb:
            assert float(got[7][:, -1].max()) == 0.0
        _, state = bank.process_planar(xr, xi, state)


def _spectral_close(got, ref, args, out_gain):
    """L and R against the plain spectral chain frame by frame (128 samples):
    a frame with no bin within 1e-4 (relative) of the plain floor to ATOL, one
    with k such bins to ATOL + k * 0.2 * nf * out_gain / 256 (spectral NR
    scales a bin by 0.2 at or under the floor and by about 0 just above it)."""
    *chain, dc0, sam_a, _, spec = args
    chain[14] = 1.0   # the spectral stage sees [l | r] before the output gain
    l, r = sweep.chain_plain(*chain, dc0, sam=sam_a)[:2]
    _, _, mag, nfloor = sweep.spectral_floor(l, r, spec.w_fwd, spec.nfloor0, spec.tail_l,
                                             spec.tail_r, spec.nr_level)
    nf = nfloor.clamp(min=0.0)
    near = ((mag - nf[..., None]).abs() <= 1e-4 * nf[..., None]).sum(-1)
    c = got[0].shape[0]
    d = torch.stack([(g - w).abs().view(c, -1, 128).amax(-1) for g, w in zip(got, ref)]).amax(0)
    assert bool(torch.isfinite(d).all())
    assert bool((d <= ATOL + near * (0.2 * out_gain / 256) * nf).all()), float(d.max())


# the spectral routes: K4 (SSB without the blanker) and K6's five; SAM +
# spectral walks the PLL a chunk ahead too. 67 rows: a last chunk of 3
SPECTRAL_ROUTES = [("sam", False), ("sam", True), ("ssb", False), ("ssb", True), ("am", False),
                   ("am", True)]


@pytest.mark.parametrize("demod, nb", SPECTRAL_ROUTES)
def test_sam_spectral_pipeline_matches_plain_over_two_segments(cuda_device, demod, nb):
    """Each spectral route (lanes_sam_spectral[_nb], K4 and K6's SSB/AM
    ones), whose kernel runs the stage as an in-block FFT, against the plain
    chain, which multiplies by the dense DFT operators, over two threaded
    segments whose last 64-row chunk holds 3 rows: the audio frame by frame
    (_spectral_close), every carry to ATOL (the PLL phase wrap-aware); one
    launch of the route's kernel a call. Locked scenes, the blanker's
    impulses far above its threshold, one on each segment's last sample."""
    channels, n = 3, 67 * 128
    bank = _lanes_bank(demod, "spectral", nb, channels, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(
        67 + nb + {"sam": 0, "ssb": 2, "am": 4}[demod])
    xr, xi = _locked(channels, n, gen, cuda_device)
    if nb:
        for pos in (n // 5, n // 2 + 3, n - 1):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
    warm = torch.full((channels,), float(torch.hypot(xr, xi).mean()), device=cuda_device)
    state = bank.init_state()._replace(nb_avg=warm)
    for _ in range(2):
        if bank.route == "spec":
            spec_args = bank.spec_args(xr, xi, state)
            args = sweep_spec.lanes_args(*spec_args)
            ref = lanes.sweep_lanes_chain_plain(*args)
            before = sweep_spec.LAUNCHES
            got = sweep_spec.sweep_spec_chain(*spec_args)
            torch.cuda.synchronize()
            assert sweep_spec.LAUNCHES == before + 1
            got = ref._replace(audio_l=got[0], audio_r=got[1], audio_tail=got[2],
                               agc_env=got[3], nfloor=got[4], spec_tail_l=got[5],
                               spec_tail_r=got[6])
        else:
            args = bank.lanes_args(xr, xi, state)
            ref = lanes.sweep_lanes_chain_plain(*args)
            before = dict(lanes.LAUNCHES)
            got = lanes.sweep_lanes_chain(*args)
            torch.cuda.synchronize()
            assert {k: v - before[k] for k, v in lanes.LAUNCHES.items() if v != before[k]} == \
                {bank.kernel: 1}
        _spectral_close((got.audio_l, got.audio_r), (ref.audio_l, ref.audio_r), args,
                        bank.params.output_gain)
        for name, g, r in zip(lanes.LanesOut._fields, got, ref):
            if g is None or name in ("audio_l", "audio_r"):
                continue
            assert bool(torch.isfinite(g).all()), name
            if name == "pll":
                _phase_close(g[0], r[0])
                g, r = g[1], r[1]
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=ATOL, rtol=0,
                                       err_msg=name)
        if nb:
            assert float(got.nb_mask[:, -1].max()) == 0.0
        _, state = bank.process_planar(xr, xi, state)


@pytest.mark.parametrize("fold, channels, counts", [
    (False, 8, (1, 1, 0, 0, 0, 0)),      # K5 + K2b
    (True, 8, (0, 0, 1, 0, 0, 0)),       # K6
    (True, 200, (0, 0, 0, 0, 1, 0)),     # K7, G = 2
])
def test_sam_bank_routes_launch_once_per_segment(cuda_device, fold, channels, counts):
    """Each FusedSAMBank route: its kernels, one launch each per segment and no
    other, and the port's ReceiverBank(SAM) within 2e-3."""
    bank = _sam_bank(channels, fold=fold)
    ref_bank = ReceiverBank(bank.config, [SAM_CENTER + 1_000.0 * k for k in range(channels)])
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    xr, xi = _locked(channels, 4096, gen, cuda_device)
    st, st_ref = bank.init_state(), ref_bank.init_state()
    for _ in range(2):
        before = _sam_counts()
        out, st = bank.process_planar(xr, xi, st)
        torch.cuda.synchronize()
        assert tuple(a - b for a, b in zip(_sam_counts(), before)) == counts
        want, st_ref = ref_bank.process_planar(xr, xi, st_ref)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(out[key].cpu().numpy(), want[key].cpu().numpy(),
                                       atol=2e-3, rtol=0)


LANES_ROUTES = [(d, nr, nb) for nr in ("denoise", "notch", "spectral") for d in ("ssb", "am", "sam")
                for nb in (False, True) if (d, nr, nb) != ("ssb", "spectral", False)]


def _lanes_bank(demod, nr, nb, channels, device=None):
    mode = {"ssb": DemodMode.USB, "am": DemodMode.AM, "sam": DemodMode.SAM}[demod]
    nr_mode = {"denoise": NRMode.DNR2, "notch": NRMode.NOTCH, "spectral": NRMode.SPEC2}[nr]
    cfg = ReceiverConfig(mode=mode, vfo_freq=7_060_000.0, capture_center_freq=SAM_CENTER,
                         agc=AGCMode.MEDIUM, nr=nr_mode, noise_blanker=nb)
    return FusedNRBank(cfg, [SAM_CENTER + 1_000.0 * k for k in range(channels)], device=device)


@pytest.mark.parametrize("demod, nr, nb", LANES_ROUTES)
def test_nr_chain_kernels_match_plain_over_two_segments(cuda_device, demod, nr, nb):
    """Each NR instantiation of the lanes kernel against the plain chain,
    every output and carry (the PLL phase wrap-aware), over two threaded
    segments, the LMS's first-block quirk in the first; one launch of the
    route's kernel per call; the bank's route is that kernel, and it is held
    to the port's ReceiverBank within 2e-3. Locked carriers (the SAM PLL is
    chaotic on noise; the LMS adapts to the tones), with the blanker
    impulses far above its threshold, one on the segment's last sample."""
    channels, n = 4, 2048
    bank = _lanes_bank(demod, nr, nb, channels, cuda_device)
    ref_bank = ReceiverBank(bank.config, [SAM_CENTER + 1_000.0 * k for k in range(channels)])
    assert (bank.route, bank.kernel) == ("lanes", lanes.kernel_name(demod, nr, nb))
    gen = torch.Generator(device=cuda_device).manual_seed(len(bank.kernel))
    xr, xi = _locked(channels, n, gen, cuda_device)
    if nb:
        for pos in sorted({n // 5, n // 2 + 3, n - 1}):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
    warm = torch.full((channels,), float(torch.hypot(xr, xi).mean()), device=cuda_device)
    state, st_ref = bank.init_state()._replace(nb_avg=warm), ref_bank.init_state()
    st_ref = st_ref._replace(nb_avg=warm.clone())
    tol = ATOL if nr == "spectral" else LMS_ATOL
    for _ in range(2):
        args = bank.lanes_args(xr, xi, state)
        ref = lanes.sweep_lanes_chain_plain(*args)
        before = dict(lanes.LAUNCHES)
        got = lanes.sweep_lanes_chain(*args)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in lanes.LAUNCHES.items() if v != before[k]} == \
            {bank.kernel: 1}
        for name, g, r in zip(lanes.LanesOut._fields, got, ref):
            assert (g is None) == (r is None), name
            if g is None:
                continue
            assert bool(torch.isfinite(g).all()), name
            if name == "pll":
                _phase_close(g[0], r[0])
                g, r = g[1], r[1]
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=tol, rtol=0,
                                       err_msg=name)
        assert (got.audio_r is None) == (nr == "denoise")
        if nb:
            assert float(got.nb_mask[:, -1].max()) == 0.0
        out, state = bank.process_planar(xr, xi, state)
        assert torch.equal(out["audio_l"], got.audio_l)
        assert (out["audio_r"] is out["audio_l"]) == (nr == "denoise")
        want, st_ref = ref_bank.process_planar(xr, xi, st_ref)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(out[key].cpu().numpy(), want[key].cpu().numpy(),
                                       atol=2e-3, rtol=0)


# the LMS routes: one channel, the last 8,192-sample chunk one row long (SAM
# at 2,176 samples: its plain PLL is one host-bound step per sample), and
# 128 channels x 2^17 but for SAM
LMS_CASES = [(d, nr, nb, 1, 2048 + 128 if d == "sam" else 8192 + 128)
             for d, nr, nb in LANES_ROUTES if nr != "spectral"] + [
    (d, nr, nb, 128, 1 << 17) for d, nr, nb in LANES_ROUTES if nr != "spectral" and d != "sam"]


@pytest.mark.parametrize("demod, nr, nb, channels, n", LMS_CASES)
def test_lms_chain_kernels_match_plain_over_whole_segments(cuda_device, demod, nr, nb,
                                                           channels, n):
    """Each LMS instantiation of the lanes kernel against the plain chain (the
    same grouped LMS algebra) over two whole threaded segments, the LMS's
    first-block quirk in the first, every output and carry: the drift over
    a long stream that a prefix cannot show, and one channel."""
    bank = _lanes_bank(demod, nr, nb, channels, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(channels + len(bank.kernel))
    xr, xi = _locked(channels, n, gen, cuda_device)
    if nb:
        for pos in sorted({n // 5, n // 2 + 3, n - 1}):
            xr[:, pos] = 8.0
            xi[:, pos] = 8.0
    warm = torch.full((channels,), float(torch.hypot(xr, xi).mean()), device=cuda_device)
    state = bank.init_state()._replace(nb_avg=warm)
    for _ in range(2):
        args = bank.lanes_args(xr, xi, state)
        ref = lanes.sweep_lanes_chain_plain(*args)
        before = dict(lanes.LAUNCHES)
        got = lanes.sweep_lanes_chain(*args)
        torch.cuda.synchronize()
        assert {k: v - before[k] for k, v in lanes.LAUNCHES.items() if v != before[k]} == \
            {bank.kernel: 1}
        for name, g, r in zip(lanes.LanesOut._fields, got, ref):
            if g is None:
                continue
            assert bool(torch.isfinite(g).all()), name
            if name == "pll":
                _phase_close(g[0], r[0])
                g, r = g[1], r[1]
            np.testing.assert_allclose(g.cpu().numpy(), r.cpu().numpy(), atol=LMS_ATOL, rtol=0,
                                       err_msg=name)
        _, state = bank.process_planar(xr, xi, state)


def test_nr_chain_wrapper_rejects_bad_arguments(cuda_device):
    """The NR chain's wrapper raises on what its kernels do not take: two NR
    stages or none, a strided input, LMS carries of the wrong shape, an
    unknown LMS mode, and SSB + spectral without the blanker (K4's route)."""
    bank = _lanes_bank("am", "notch", False, 4, cuda_device)
    gen = torch.Generator(device=cuda_device).manual_seed(9)
    xr, xi = _locked(4, 512, gen, cuda_device)
    args = bank.lanes_args(xr, xi, bank.init_state())
    lms_a = args[-2]
    spec_a = sweep.SpecArgs(torch.zeros((512, 512), device=cuda_device),
                            torch.zeros((512, 256), device=cuda_device),
                            torch.zeros(4, device=cuda_device),
                            torch.zeros((4, 128), device=cuda_device),
                            torch.zeros((4, 128), device=cuda_device), 30.0)
    wide = torch.zeros((4, 1024), device=cuda_device)
    for bad in (args[:-2] + (lms_a, spec_a), args[:-2] + (None, None),
                (wide[:, ::2], wide[:, ::2]) + args[2:],
                args[:-2] + (lms_a._replace(weights=lms_a.weights[:, :64]), None),
                args[:-2] + (lms_a._replace(mode="both"), None)):
        with pytest.raises(ValueError):
            lanes.sweep_lanes_chain(*bad)
    ssb = _lanes_bank("ssb", "spectral", True, 4, cuda_device)
    ssb_args = ssb.lanes_args(xr, xi, ssb.init_state())
    with pytest.raises(ValueError, match="sweep_spec"):
        lanes.sweep_lanes_chain(*ssb_args[:17], False, *ssb_args[18:])


@pytest.mark.parametrize("channels, n, block_c, out_gain", [
    (8, 4 * 4096, 8, 1.0),      # four chunks of 64 rows
    (3, 3 * 2048, 1, 1.1),      # a partial last chunk (48 rows)
    (16, 5 * 128, 4, 1.0),      # five rows
])
def test_sweep_mix_kernel_matches_plain(cuda_device, channels, n, block_c, out_gain):
    from radiodsp_sdr_rx_tpu_torch.ops import fir_design, nco
    from radiodsp_sdr_rx_tpu_torch.ops.operators import ssb_demod_operator

    gen = torch.Generator(device=cuda_device).manual_seed(n)
    xr = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
    xi = torch.randn((channels, n), generator=gen, device=cuda_device) * 0.1
    w = torch.as_tensor(np.ascontiguousarray(ssb_demod_operator(
        fir_design.design_filter_mask(300.0, 4000.0, 44117.64706))), device=cuda_device)
    inc = torch.tensor([int(nco.freq_to_phase_inc(1000.0 * k, 44117.64706))
                        for k in range(channels)], dtype=torch.int64, device=cuda_device)
    ph = torch.randint(0, 2**32, (channels,), generator=gen, device=cuda_device,
                       dtype=torch.int64)
    before = sweep.LAUNCHES_SWEEP_MIX
    got = sweep.sweep_mix_filter_demod(xr, xi, inc, ph, w, out_gain, block_c)
    assert sweep.LAUNCHES_SWEEP_MIX == before + 1
    ref = sweep.sweep_mix_filter_demod_plain(xr, xi, inc, ph, w, out_gain, block_c)
    _close([got], [ref])
    k2a = staged.fused_mix_filter_demod(xr, xi, inc, ph, w,
                                        torch.zeros((channels, 256), device=cuda_device))
    assert torch.equal(got, k2a * float(np.float32(out_gain)))
    for chunk_t in (128, 2048, n):
        assert torch.equal(sweep.sweep_mix_filter_demod(xr, xi, inc, ph, w, out_gain, block_c,
                                                        chunk_t), got)
    with pytest.raises(ValueError):
        sweep.sweep_mix_filter_demod(xr[:, :n - 64], xi[:, :n - 64], inc, ph, w)


def _leaves(state):
    for v in state:
        yield from (_leaves(v) if isinstance(v, tuple) else (v,))


def _receiver_cfg(**kw):
    return ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_160_000.0,
                          capture_center_freq=7_150_000.0, agc=AGCMode.OFF, **kw)


@pytest.mark.parametrize("kw", [
    {"nr": NRMode.NOTCH},
    {"mode": DemodMode.AM, "nr": NRMode.DNR2, "fft_length": 512, "agc": AGCMode.MEDIUM},
    {"nr": NRMode.SPEC2, "conv_first": True, "conv_inline_denoise": True},
    {"conv_first": True, "noise_blanker": True, "fft_length": 128},
])
def test_receiver_on_card_matches_cpu(cuda_device, kw):
    from radiodsp_sdr_rx_tpu_torch.utils import scenes

    cfg = _receiver_cfg().with_(**kw)
    iq, _ = scenes.qrm_ssb_scene(2 * 8192)
    card, cpu = Receiver(cfg), Receiver(cfg, device="cpu")
    st_c, st_h = card.init_state(), cpu.init_state()
    lms_runs = lms_bank.LAUNCHES
    tol = LMS_ATOL if cfg.nr.kind in ("lms", "notch") else ATOL
    for seg in range(2):
        out_c, st_c = card.process(iq[seg * 8192:(seg + 1) * 8192], st_c)
        out_h, st_h = cpu.process(iq[seg * 8192:(seg + 1) * 8192], st_h)
        for key in ("audio_l", "audio_r"):
            assert out_c[key].is_cuda and out_c[key].shape == (8192,)
            np.testing.assert_allclose(out_c[key].cpu().numpy(), out_h[key].numpy(), atol=tol,
                                       rtol=0)
    assert lms_bank.LAUNCHES - lms_runs == (2 if cfg.nr.kind in ("lms", "notch") else 0)
    for a, b in zip(_leaves(st_c), _leaves(st_h)):
        np.testing.assert_allclose(a.cpu().numpy().astype(np.float64),
                                   b.numpy().astype(np.float64), atol=tol, rtol=1e-4)


def test_receiver_on_card_matches_the_goldens(cuda_device):
    from pathlib import Path

    from radiodsp_sdr_rx_tpu_torch.utils import scenes

    for name, cfg, iq, _ in scenes.golden_cases():
        rx = Receiver(cfg)
        out, _ = rx.process(iq, rx.init_state())
        want = np.load(Path(__file__).parent / "goldens" / f"{name}.npz")["audio_l"]
        np.testing.assert_allclose(out["audio_l"][:len(want)].cpu().numpy(), want,
                                   atol=1e-4 * max(float(np.abs(want).max()), 1e-6), rtol=0,
                                   err_msg=name)


def test_receiver_i2s_repair_on_card_matches_cpu(cuda_device):
    from radiodsp_sdr_rx_tpu_torch.utils import siggen

    n, seg = 8 * 4096, 4096
    audio = siggen.voice_like(n, 44117.64706)
    iq = siggen.ssb_from_audio(audio, 10_000.0, 44117.64706, "usb", amp=0.4)
    iq = iq + siggen.noise(n, 0.01)
    q = iq.imag.copy()
    q[2 * seg + 1000:] = q[2 * seg + 999:-1]    # Q one sample late from mid segment 2
    iq = (iq.real + 1j * q).astype(np.complex64)
    cfg = _receiver_cfg(auto_iq_repair=True)
    card, cpu = Receiver(cfg), Receiver(cfg, device="cpu")
    st_c, st_h = card.init_state(), cpu.init_state()
    seq_c, seq_h = [], []
    for k in range(8):
        out_c, st_c = card.process(iq[k * seg:(k + 1) * seg], st_c)
        out_h, st_h = cpu.process(iq[k * seg:(k + 1) * seg], st_h)
        seq_c.append(card.iq_repair_idx)
        seq_h.append(cpu.iq_repair_idx)
        np.testing.assert_allclose(out_c["audio_l"].cpu().numpy(), out_h["audio_l"].numpy(),
                                   atol=ATOL, rtol=0)
    assert seq_c == seq_h == [0, 0, 0, 0, 2, 2, 2, 2]


@pytest.mark.parametrize("shards", [2, 4, 8])
@pytest.mark.parametrize("shape", [(1, 128), (128, 128), (3, 5)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_ring_halo_kernel_matches_plain(cuda_device, shards, shape, dtype):
    """K9 (parallel/halo.py): a ring of shards on one card, one launch per
    exchange, bit for bit with the plain copies; (3, 5) f32 takes the
    kernel's scalar path (15 floats, no float4)."""
    from radiodsp_sdr_rx_tpu_torch.parallel import halo

    gen = torch.Generator(device=cuda_device).manual_seed(shards)
    blocks = [torch.randn(shape, generator=gen, device=cuda_device, dtype=dtype)
              for _ in range(shards)]
    first = torch.randn(shape[-1:], generator=gen, device=cuda_device, dtype=dtype)
    before = halo.LAUNCHES
    ring = halo.ring_shift_right(blocks)
    shifted = halo.shift_from_left_kernel(blocks, first)
    torch.cuda.synchronize()
    assert halo.LAUNCHES - before == 2
    assert all(torch.equal(a, b) for a, b in zip(ring, halo.ring_shift_right_plain(blocks)))
    assert all(torch.equal(a, b) for a, b in zip(shifted, halo.shift_from_left_plain(blocks,
                                                                                     first)))
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(ring, blocks))
    if shards % 2 == 0:   # two lines of shards/2 in one launch
        before = halo.LAUNCHES
        got = halo.shift_from_left_kernel(blocks, [first, -first], ring=shards // 2)
        torch.cuda.synchronize()
        assert halo.LAUNCHES - before == 1
        want = halo.shift_from_left_plain(blocks, [first, -first], ring=shards // 2)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_ring_halo_kernel_refuses_strided_blocks(cuda_device):
    from radiodsp_sdr_rx_tpu_torch.parallel import halo

    x = torch.zeros(4, 256, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        halo.ring_shift_right([x[:, :128], x[:, 128:]])


def test_ring_halo_kernel_across_cards():
    """Shards on several cards of one process: one launch per source card,
    writing into the neighbour's buffer by peer access."""
    from radiodsp_sdr_rx_tpu_torch.parallel import halo

    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA cards")
    devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    blocks = [torch.randn((128, 128), device=d, dtype=torch.complex64) for d in devs]
    before = halo.LAUNCHES
    got = halo.shift_from_left_kernel(blocks, torch.zeros(128, dtype=torch.complex64))
    for d in devs:
        torch.cuda.synchronize(d)
    assert halo.LAUNCHES - before == len(devs) - 1   # the last card's block goes nowhere
    want = halo.shift_from_left_plain(blocks, torch.zeros(128, dtype=torch.complex64))
    assert all(g.device == w.device and torch.equal(g, w) for g, w in zip(got, want))
    ring = halo.ring_shift_right(blocks)
    for d in devs:
        torch.cuda.synchronize(d)
    assert all(torch.equal(g, w) for g, w in zip(ring, halo.ring_shift_right_plain(blocks)))
    assert torch.cuda.current_device() == 0
    # the time-sharded chain over every card (make_mesh's default devices)
    from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
    from radiodsp_sdr_rx_tpu_torch.parallel import make_mesh, make_time_sharded_ssb_chain

    p = build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_060_000.0,
                                    capture_center_freq=7_050_000.0, iq_gain_balance=1.0))
    args = (p.nco_inc, p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.output_gain)
    iq = torch.randn(len(devs) * 8192, dtype=torch.complex64) * 0.1
    mesh = make_mesh(time=len(devs))
    assert [d.index for d in mesh.devices[0]] == list(range(len(devs)))
    got = {h: make_time_sharded_ssb_chain(mesh, halo=h)(iq, *args).cpu()
           for h in ("kernel", "ppermute")}
    one = make_time_sharded_ssb_chain(make_mesh(time=len(devs), devices=[devs[0]] * len(devs)),
                                      halo="kernel")(iq, *args).cpu()
    assert torch.equal(got["kernel"], got["ppermute"])
    np.testing.assert_allclose(got["kernel"].numpy(), one.numpy(), atol=ATOL, rtol=0)


def test_time_sharded_chain_kernel_halo_on_card(cuda_device):
    """make_time_sharded_ssb_chain on time=4 over one card: the kernel halo
    equals the ppermute halo bit for bit, 2 launches a call, and the chain
    equals it on the CPU at 1e-4."""
    from radiodsp_sdr_rx_tpu_torch.models.receiver import build_params
    from radiodsp_sdr_rx_tpu_torch.parallel import halo, make_mesh, make_time_sharded_ssb_chain

    cfg = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_060_000.0,
                         capture_center_freq=7_050_000.0, agc=AGCMode.FAST,
                         iq_gain_balance=1.0)
    p = build_params(cfg)
    args = (p.nco_inc, p.w_sideband, p.w_audio, p.agc_release, p.agc_target, p.agc_max_gain,
            p.output_gain)
    rng = np.random.default_rng(9)
    iq = ((rng.standard_normal(4 * 8192) + 1j * rng.standard_normal(4 * 8192)) * 0.1
          ).astype(np.complex64)
    out = {}
    for dev in ("cuda", "cpu"):
        mesh = make_mesh(time=4, devices=[torch.device(dev)] * 4)
        for h in ("kernel", "ppermute"):
            before = halo.LAUNCHES
            out[dev, h] = make_time_sharded_ssb_chain(mesh, halo=h)(
                torch.from_numpy(iq).to(dev), *args).cpu()
            assert halo.LAUNCHES - before == (2 if (dev, h) == ("cuda", "kernel") else 0)
    assert torch.equal(out["cuda", "kernel"], out["cuda", "ppermute"])
    np.testing.assert_allclose(out["cuda", "kernel"].numpy(), out["cpu", "kernel"].numpy(),
                               atol=ATOL, rtol=0)
