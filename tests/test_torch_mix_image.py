"""K2a (``mix_demod``) and K8 (``sweep_mix_demod``) on the tensor cores,
modelled on the CPU.

Both run ``csrc/staged.cu``'s mix_demod_kernel: the band-pass product
frames @ w_ssb as 3xTF32 on the tensor cores, on 128-row items. An item's
frames come from two row buffers (I and Q) whose row 0 is the row before the
item: the carried tail (K2a) or zeros (K8) before a channel's first item,
the stream's own row before any other; rows past the stream's end are zeros.
The operator comes as ``ops/staged.mix_image``: ``tf32x3.tf32_image(w_ssb,
1)``, each 8 KB K step one part that both warpgroups read. Held here:

- the item layout's frames are the stream's frames bit for bit, over two
  whole items and a partial one;
- the 3xTF32 model of the product (``tf32x3.matmul_3xtf32``) on those frames
  and the JAX ``build_params``' ``w_ssb`` is within 2e-6 of max |y| of
  float64 (tests/test_torch_tf32x3.py's bound for the other products), for
  K2a's warm tail and gains and for K8's stream start, and within 1e-5 of the JAX
  ``fused_mix_filter_demod`` (Pallas interpret mode), as
  tests/test_torch_staged.py holds the plain fp32 version;
- ``mix_image`` is that image, built once per operator, anew after an
  in-place change, and let go with its operator; the wrappers build none for
  CPU tensors, and ``check_image`` refuses what the kernel cannot read.

The kernels themselves run only on the card (tests/test_torch_kernels_cuda.py).
"""

import numpy as np
import pytest
import torch

from radiodsp_sdr_rx_tpu.models.config import AGCMode, DemodMode, ReceiverConfig
from radiodsp_sdr_rx_tpu.models.receiver import build_params
from radiodsp_sdr_rx_tpu.ops import pallas_kernels as jk
from radiodsp_sdr_rx_tpu_torch.ops import chain_common, staged, sweep, tf32x3
from radiodsp_sdr_rx_tpu_torch.ops.chain_common import BLOCK, mix

ITEM = 128            # rows of an item (csrc/staged.cu's kItemRows)
PRODUCT_TOL = 2e-6    # of max |y|, the model against float64
JAX_TOL = 1e-5
C, ROWS = 8, 320      # two whole items and a partial one of 64 rows


def _w_ssb():
    p = build_params(ReceiverConfig(mode=DemodMode.USB, vfo_freq=7_200_000.0,
                                    capture_center_freq=7_190_000.0, agc=AGCMode.MEDIUM))
    return torch.from_numpy(np.ascontiguousarray(p.w_ssb, np.float32))


def _inputs(seed, warm):
    """Unscaled IQ (C, ROWS x 128), DDS words, a (C, 256) tail (scaled,
    unmixed; zeros at a stream start) and the f32 gains of I and Q."""
    rng = np.random.default_rng(seed)
    xr, xi = (rng.standard_normal((C, ROWS * BLOCK)).astype(np.float32) * 0.1 for _ in range(2))
    inc = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.int64)
    phase = rng.integers(0, 2**32, C, dtype=np.uint64).astype(np.int64)
    tail = (rng.standard_normal((C, 2 * BLOCK)).astype(np.float32) * 0.1 if warm
            else np.zeros((C, 2 * BLOCK), np.float32))
    g_i = np.float32(0.7) if warm else np.float32(1.0)
    g_q = g_i * np.float32(1.02) if warm else np.float32(1.0)
    return xr, xi, inc, phase, tail, g_i, g_q


def _mixed(xr, xi, inc, phase, tail, g_i, g_q):
    """The kernel's mixed rows: the scaled stream (C, ROWS, 128) each of I and
    Q, and the mixed tail (C, 128) each."""
    inc, phase = torch.from_numpy(inc), torch.from_numpy(phase)
    pos = torch.arange(ROWS * BLOCK, dtype=torch.int64)
    br, bi = mix(torch.from_numpy(xr) * float(g_i), torch.from_numpy(xi) * float(g_q), phase,
                 inc, pos)
    t = torch.from_numpy(tail)
    tr, ti = mix(t[:, :BLOCK], t[:, BLOCK:], phase, inc, pos[:BLOCK] - BLOCK)
    return br.view(C, ROWS, BLOCK), bi.view(C, ROWS, BLOCK), tr, ti


def _item_frames(br, bi, tr, ti):
    """(C, ROWS, 512) frames as the kernel builds them, item by item: each
    item's two row buffers of ITEM + 1 rows, row 0 the tail (item 0) or the
    stream's row before the item, zeros past the stream's end; the frame of
    item row r is [buffer row r | row r + 1] of I, then of Q."""
    out = []
    for row0 in range(0, ROWS, ITEM):
        rows = min(ITEM, ROWS - row0)
        bufs = []
        for plane, t in ((br, tr), (bi, ti)):
            buf = torch.zeros(C, ITEM + 1, BLOCK)
            buf[:, 0] = t if row0 == 0 else plane[:, row0 - 1]
            buf[:, 1:rows + 1] = plane[:, row0:row0 + rows]
            bufs += [buf[:, :-1], buf[:, 1:]]
        out.append(torch.cat(bufs, dim=-1)[:, :rows])
    return torch.cat(out, dim=1)


def _stream_frames(br, bi, tr, ti):
    """[prev_r | cur_r | prev_i | cur_i] of the whole stream
    (``chain_common.demod_frames``'s)."""
    prev_r = torch.cat([tr[:, None], br[:, :-1]], dim=1)
    prev_i = torch.cat([ti[:, None], bi[:, :-1]], dim=1)
    return torch.cat([prev_r, br, prev_i, bi], dim=-1)


@pytest.mark.parametrize("warm", [True, False])
def test_item_frames_are_the_stream_frames(warm):
    planes = _mixed(*_inputs(1 + warm, warm))
    assert torch.equal(_item_frames(*planes), _stream_frames(*planes))


@pytest.mark.parametrize("warm", [True, False])
def test_model_product_matches_float64_on_item_frames(warm):
    frames = _item_frames(*_mixed(*_inputs(3 + warm, warm))).reshape(-1, 4 * BLOCK)
    w = _w_ssb()
    want = torch.matmul(frames.double(), w.double())
    got = tf32x3.matmul_3xtf32(frames, w)
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert float((got.double() - want).abs().max()) <= PRODUCT_TOL * float(want.abs().max())


@pytest.mark.parametrize("warm", [True, False])
def test_model_mix_demod_matches_jax_interpret(warm):
    xr, xi, inc, phase, tail, g_i, g_q = _inputs(5 + warm, warm)
    w = _w_ssb()
    want = jk.fused_mix_filter_demod(xr * g_i, xi * g_q, inc.astype(np.uint32),
                                     phase.astype(np.uint32), w.numpy(), tail=tail,
                                     block_t=2048, interpret=True)
    frames = _item_frames(*_mixed(xr, xi, inc, phase, tail, g_i, g_q))
    got = tf32x3.matmul_3xtf32(frames.reshape(-1, 4 * BLOCK), w).reshape(C, ROWS * BLOCK)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=JAX_TOL, rtol=0)


def _count_builds(monkeypatch):
    built = []
    real = tf32x3.tf32_image
    monkeypatch.setattr(tf32x3, "tf32_image", lambda w, parts, ksplit=1: built.append(parts)
                        or real(w, parts, ksplit))
    return built


def test_mix_image_is_the_kernels_layout():
    w = _w_ssb()
    image = staged.mix_image(w)
    assert tuple(image.shape) == staged.IMAGE_SHAPE
    assert image.is_contiguous() and image.data_ptr() % 16 == 0
    assert torch.equal(image, tf32x3.tf32_image(w, 1))
    staged.check_image(image, torch.device("cpu"))


def test_mix_image_is_built_once_per_operator(monkeypatch):
    built = _count_builds(monkeypatch)
    w = _w_ssb()
    first = staged.mix_image(w)
    assert staged.mix_image(w) is first and built == [1]
    w.mul_(1.0)   # an in-place change: a new version, a new image
    again = staged.mix_image(w)
    assert again is not first and built == [1, 1]
    assert torch.equal(again, first)


def test_mix_image_cache_lets_go_of_dead_operators():
    w = _w_ssb()
    staged.mix_image(w.clone())   # an operator dropped at once
    staged.mix_image(w)
    assert all(r() is not None for refs, _ in chain_common._PER_OPERATOR.values() for r in refs)


def test_cpu_wrappers_build_no_image(monkeypatch):
    built = _count_builds(monkeypatch)
    xr, xi, inc, phase, tail, g_i, g_q = _inputs(7, True)
    args = (torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(inc),
            torch.from_numpy(phase), _w_ssb())
    before = (staged.LAUNCHES_MIX_DEMOD, sweep.LAUNCHES_SWEEP_MIX)
    got = staged.fused_mix_filter_demod(*args, torch.from_numpy(tail), float(g_i), float(g_q))
    assert torch.equal(got, staged.fused_mix_filter_demod_plain(
        *args, torch.from_numpy(tail), float(g_i), float(g_q)))
    sweep.sweep_mix_filter_demod(*args, 1.1)
    assert not built
    assert (staged.LAUNCHES_MIX_DEMOD, sweep.LAUNCHES_SWEEP_MIX) == before


@pytest.mark.parametrize("bad", [
    None,                                              # no image
    torch.zeros(32, 2, 2, 1024),                       # K1-ssb's band-pass image
    torch.zeros(staged.IMAGE_SHAPE, dtype=torch.float64),
    torch.zeros(64 * 2 * 1024 + 1)[1:].view(staged.IMAGE_SHAPE),   # 4 bytes off 16
    torch.zeros(64, 1, 1024, 2).transpose(2, 3),       # not contiguous
])
def test_check_image_refuses_what_the_kernel_cannot_read(bad):
    with pytest.raises(ValueError):
        staged.check_image(bad, torch.device("cpu"))
