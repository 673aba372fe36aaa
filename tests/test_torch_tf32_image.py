"""The operators' images of the SSB chain's tensor-core feed, on the CPU.

K1-ssb (``sweep_chain_ssb``) and K1-mono (``sweep_chain_ssb_mono``) read
their operators pre-split and pre-laid (``csrc/tc_gemm.cuh``'s feed), and so
do K2a (``mix_demod``) and K8 (``sweep_mix_demod``), whose image of ``w_ssb``
(``ops/staged.mix_image``) is one part a K step that both warpgroups read:
``ops/tf32x3.tf32_image`` splits each fp32 operator into TF32 big and small
(``split_tf32``, the kernels' split) and lays each K step of the block out as
one contiguous block of both warpgroups' parts, each big then small, in
``wgmma``'s K-major core-matrix layout without a swizzle (column n, row k at
byte 16 (n % 8) + 128 (k // 4) + 256 (n // 8) + 4 (k % 4)); the kernel
brings each step into shared memory with one bulk copy. Held here:

- the images of the bank's operators, built from the JAX ``build_params``
  (``w_ssb`` 512 x 128 in one range, split over K and, for K2a, not;
  ``w_pbt`` 256 x 256 in two, and ``w_pbt``'s L half 256 x 128 in two),
  read back through that formula, give ``split_tf32``'s big and small bit
  for bit;
- every K step of the two warpgroups is one contiguous block at a 16-byte
  aligned offset, of the size the kernel copies (16 KB, or 8 KB for L's
  half and for K2a's one part), the band-pass's split over K (step j: K
  steps j and 32 + j);
- ``ops/sweep.ssb_image`` builds an image once while its operators stay
  unchanged, anew after they change; the banks build theirs once, not per
  segment.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.config import AGCMode, DemodMode, NRMode, ReceiverConfig
from radiodsp_sdr_rx_tpu.models.receiver import build_params
from radiodsp_sdr_rx_tpu_torch.models import config as tconfig
from radiodsp_sdr_rx_tpu_torch.models.fused import FusedNRBank, FusedSSBBank
from radiodsp_sdr_rx_tpu_torch.ops import chain_common, sweep, tf32x3

CFG = ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0, capture_center_freq=7_190_000.0,
                     agc=AGCMode.MEDIUM)


def _operators():
    p = build_params(CFG)
    return {"w_ssb": torch.from_numpy(np.asarray(p.w_ssb, np.float32)),
            "w_pbt": torch.from_numpy(np.asarray(p.w_pbt, np.float32))}


# (operator, its columns, the warpgroups' K shares and column ranges, a
# step's bytes: the kernel's one copy)
CASES = [("w_ssb", slice(None), 2, 1, 16384), ("w_pbt", slice(None), 1, 2, 16384),
         ("w_pbt", slice(0, 128), 1, 2, 8192), ("w_ssb", slice(None), 1, 1, 8192)]


def _read_back(image, k, n, ksplit, parts):
    """(big, small), each (K, N), read from the flat image by the layout
    formula: step j, K share h, column range p, big then small."""
    flat = image.reshape(-1).view(torch.int32).numpy()
    nc, steps = n // parts, k // 8 // ksplit
    part = 2 * 8 * nc
    kk, nn = np.meshgrid(np.arange(k), np.arange(n), indexing="ij")
    h, j, p, nl, kl = kk // 8 // steps, kk // 8 % steps, nn // nc, nn % nc, kk % 8
    off = ((j * ksplit + h) * parts + p) * part + 4 * (nl % 8) + 32 * (kl // 4) \
        + 64 * (nl // 8) + kl % 4
    return flat[off], flat[off + 8 * nc]


@pytest.mark.parametrize("name, cols, ksplit, parts, step_bytes", CASES)
def test_image_reads_back_as_the_split(name, cols, ksplit, parts, step_bytes):
    w = _operators()[name][:, cols].contiguous()
    k, n = w.shape
    image = tf32x3.tf32_image(w, parts, ksplit)
    assert image.shape == (k // 8 // ksplit, ksplit * parts, 2, 8 * n // parts)
    big, small = tf32x3.split_tf32(w)
    got_big, got_small = _read_back(image, k, n, ksplit, parts)
    assert np.array_equal(got_big, big.view(torch.int32).numpy())
    assert np.array_equal(got_small, small.view(torch.int32).numpy())


@pytest.mark.parametrize("name, cols, ksplit, parts, step_bytes", CASES)
def test_steps_are_contiguous_and_aligned(name, cols, ksplit, parts, step_bytes):
    w = _operators()[name][:, cols]
    image = tf32x3.tf32_image(w, parts, ksplit)
    assert image.is_contiguous() and image.data_ptr() % 16 == 0
    assert image[0].numel() * 4 == step_bytes and step_bytes % 16 == 0
    assert image.shape[0] == w.shape[0] // 8 // ksplit   # a product's K steps of the block
    for j in range(image.shape[0]):
        assert image[j].data_ptr() - image.data_ptr() == j * step_bytes
        assert image[j].is_contiguous()


def test_ssb_image_is_the_kernels_layout():
    ops = _operators()
    image = sweep.ssb_image(ops["w_ssb"], ops["w_pbt"])
    assert torch.equal(image.band, tf32x3.tf32_image(ops["w_ssb"], 1, ksplit=2))
    assert torch.equal(image.pbt, tf32x3.tf32_image(ops["w_pbt"], 2))
    mono = sweep.ssb_image(ops["w_ssb"], ops["w_pbt"], emit_r=False)
    assert torch.equal(mono.pbt, tf32x3.tf32_image(ops["w_pbt"][:, :128], 2))
    # L's columns 0-63 and 64-127 (the mono warpgroups' parts) lie in the
    # first and second 2 KB of the stereo first part's big and small
    for wg in range(2):
        assert torch.equal(image.pbt[:, 0, :, 512 * wg:512 * (wg + 1)], mono.pbt[:, wg])


def test_image_rejects_what_the_feed_cannot_lay_out():
    with pytest.raises(ValueError, match="no image"):
        tf32x3.tf32_image(torch.zeros(12, 128), 1)
    with pytest.raises(ValueError, match="no image"):
        tf32x3.tf32_image(torch.zeros(24, 128), 1, ksplit=2)
    with pytest.raises(ValueError, match="no image"):
        tf32x3.tf32_image(torch.zeros(16, 72), 2)
    with pytest.raises(ValueError, match="fp32"):
        tf32x3.tf32_image(torch.zeros(16, 128, dtype=torch.float64), 1)


@pytest.mark.parametrize("emit_r", [True, False])
def test_ssb_image_is_built_once_per_operators(monkeypatch, emit_r):
    ops = _operators()
    w_ssb, w_pbt = ops["w_ssb"], ops["w_pbt"]
    built = []
    real = tf32x3.tf32_image
    monkeypatch.setattr(tf32x3, "tf32_image", lambda w, parts, ksplit=1: built.append(parts)
                        or real(w, parts, ksplit))
    first = sweep.ssb_image(w_ssb, w_pbt, emit_r)
    assert sweep.ssb_image(w_ssb, w_pbt, emit_r) is first and len(built) == 2
    assert first.emit_r == emit_r
    assert first.band.shape == (32, 2, 2, 1024)
    assert first.pbt.shape == (32, 2, 2, 1024 if emit_r else 512)
    w_pbt.mul_(1.0)   # an in-place change: a new version, a new image
    again = sweep.ssb_image(w_ssb, w_pbt, emit_r)
    assert again is not first and len(built) == 4
    assert torch.equal(again.band, first.band) and torch.equal(again.pbt, first.pbt)


def test_ssb_image_cache_lets_go_of_dead_operators():
    ops = _operators()
    sweep.ssb_image(ops["w_ssb"].clone(), ops["w_pbt"].clone())   # operators dropped at once
    sweep.ssb_image(ops["w_ssb"], ops["w_pbt"])
    assert all(r() is not None for refs, _ in chain_common._PER_OPERATOR.values() for r in refs)


def test_ssb_image_checks_the_operators():
    ops = _operators()
    with pytest.raises(ValueError):
        sweep.ssb_image(ops["w_pbt"], ops["w_pbt"])
    image = sweep.ssb_image(ops["w_ssb"], ops["w_pbt"])
    with pytest.raises(ValueError, match="emit_r"):
        sweep._check_image(image, False, torch.device("cpu"))
    with pytest.raises(ValueError, match="image"):
        sweep._check_image(None, True, torch.device("cpu"))
    sweep._check_image(image, True, torch.device("cpu"))


def _count_builds(monkeypatch):
    built = []
    real = tf32x3.tf32_image
    monkeypatch.setattr(tf32x3, "tf32_image", lambda w, parts, ksplit=1: built.append(parts)
                        or real(w, parts, ksplit))
    return built


@pytest.mark.parametrize("nr, emit_r", [(None, True), (tconfig.NRMode.DNR2, False),
                                        (tconfig.NRMode.SPEC2, True), (tconfig.NRMode.NOTCH, None)])
def test_banks_build_their_image_once(monkeypatch, nr, emit_r):
    built = _count_builds(monkeypatch)
    cfg = tconfig.ReceiverConfig(mode=tconfig.DemodMode.USB, vfo_freq=7_200_000.0,
                                 capture_center_freq=7_190_000.0, agc=tconfig.AGCMode.MEDIUM)
    freqs = [7_190_000.0 + 1_000.0 * k for k in range(3)]
    bank = FusedSSBBank(cfg, freqs, device="cpu") if nr is None else \
        FusedNRBank(cfg.with_(nr=nr), freqs, fold=False, device="cpu")
    assert len(built) == (0 if emit_r is None else 2)
    if emit_r is not None:
        assert bank.image.emit_r == emit_r
    rng = np.random.default_rng(3)
    state = bank.init_state()
    for _ in range(3):
        x = torch.from_numpy((rng.standard_normal((3, 1024)) * 0.1).astype(np.float32))
        _, state = bank.process_planar(x, x, state)
    assert len(built) == (0 if emit_r is None else 2)


@pytest.mark.parametrize("backend, nb", [("staged", False), ("sweep", True)])
def test_banks_off_the_feed_build_no_image(monkeypatch, backend, nb):
    built = _count_builds(monkeypatch)
    cfg = tconfig.ReceiverConfig(mode=tconfig.DemodMode.USB, vfo_freq=7_200_000.0,
                                 capture_center_freq=7_190_000.0, noise_blanker=nb)
    bank = FusedSSBBank(cfg, [7_190_000.0], backend=backend, device="cpu")
    assert bank.image is None and not built
