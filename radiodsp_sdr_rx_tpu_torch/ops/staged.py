"""The two kernels of the staged SSB chain, with the AGC left between them.

Counterparts of ``radiodsp_sdr_rx_tpu/ops/pallas_kernels.py:76-231``:

  fused_mix_filter_demod  (:119, kernel ``_mix_demod_kernel`` :83): input
      gain / IQ balance, DDS NCO mix, overlap-save band-pass + SSB demod as
      frames [prev_r | cur_r | prev_i | cur_i] (rows,512) @ w_ssb (512,128).
      Returns the pre-AGC audio (C, n). The JAX wrapper's ``out_gain`` is
      not taken: the bank applies its output gain after the PBT.
  pbt_filter  (:189, kernel ``_pbt_kernel`` :177): frames [prev | cur]
      (rows,256) @ w_pbt (256,256) -> (L, R), output gain.

Both are stateless: the framing carry is the ``tail`` argument, the previous
segment's last block. For ``fused_mix_filter_demod`` it is (C, 256) [re|im]
of the SCALED, UNMIXED input, which the kernel mixes at positions
-128..-1. The JAX wrapper takes input that is already scaled; here the input
gains ``gain_i`` and ``gain_q`` are one f32 multiply each inside the kernel,
which gives the same bits as the JAX caller's ``xr * in_gain`` and saves
two passes over the stream. The tail is not scaled again.

CUDA tensors launch ``csrc/staged.cu`` (``mix_demod``, ``pbt``) or raise; CPU
tensors run the ``*_plain`` versions, which the tests and ``chip_smoke.py``
hold the kernels to. ``mix_demod`` (and K8,
``ops/sweep.sweep_mix_filter_demod``) reads its operator as ``mix_image``
lays it out, split into TF32 big and small for the tensor cores: built once
per operator at the first CUDA call; a CPU call builds none.
``LAUNCHES_MIX_DEMOD`` and ``LAUNCHES_PBT`` count the launches.
The JAX wrappers' TPU tiling (``block_c``, ``block_t``, ``interpret``) has
no meaning here and is not taken; any ``n`` that is a multiple of 128 is.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from radiodsp_sdr_rx_tpu_torch.ops.chain_common import (
    BLOCK,
    check_launch,
    check_stream,
    check_tensors,
    demod_frames,
    mix,
    pbt_frames,
    per_operator,
)
from radiodsp_sdr_rx_tpu_torch.ops import tf32x3
from radiodsp_sdr_rx_tpu_torch.utils import build
from radiodsp_sdr_rx_tpu_torch.utils.profiling import span

LAUNCHES_MIX_DEMOD = 0
LAUNCHES_PBT = 0
IMAGE_SHAPE = (64, 1, 2, 1024)   # mix_image: 64 K steps of 8 KB, one part each


def _check_mix_demod(xr, xi, inc, phase0, w, tail):
    check_stream(xr)
    c, n = xr.shape
    check_tensors({"xi": (xi, (c, n), torch.float32),
            "inc": (inc, (c,), torch.int64),
            "phase0": (phase0, (c,), torch.int64),
            "w": (w, (512, 128), torch.float32),
            "tail": (tail, (c, 2 * BLOCK), torch.float32),
            "xr": (xr, (c, n), torch.float32)}, xr.device)


def mix_image(w: torch.Tensor) -> torch.Tensor:
    """The image of the (512, 128) ``ssb_demod_operator`` ``w`` that
    ``mix_demod`` and ``sweep_mix_demod`` read (``tf32x3.tf32_image(w, 1)``:
    64 K steps of 8 rows, each one 8 KB part that both of a block's
    warpgroups read), on w's device. Built once while w stays unchanged
    (``per_operator``) and kept while w lives."""
    def make():
        check_tensors({"w": (w, (512, 128), torch.float32)}, w.device)
        return tf32x3.tf32_image(w, 1)

    return per_operator("mix_image", (w,), make)


def check_image(image, device) -> None:
    """Raise ValueError unless ``image`` is a ``mix_image`` on ``device``."""
    tf32x3.check_image({"image (staged.mix_image(w))": (image, IMAGE_SHAPE)}, device)


def _checkpbt_frames(audio, w, tail):
    check_stream(audio)
    c, n = audio.shape
    check_tensors({"w": (w, (256, 256), torch.float32),
            "tail": (tail, (c, BLOCK), torch.float32),
            "audio": (audio, (c, n), torch.float32)}, audio.device)


_PTR, _I32, _F32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_ARGTYPES = {  # the extern "C" launchers of csrc/staged.cu
    "mix_demod": [_PTR] * 7 + [_I32] * 3 + [_F32] * 2 + [_PTR],
    "pbt": [_PTR] * 5 + [_I32] * 3 + [_F32] + [_PTR],
    "sweep_mix_demod": [_PTR] * 6 + [_I32] * 3 + [_F32] + [_PTR],   # ops/sweep.py's K8
}


def launch(name: str, device: torch.device, *args) -> None:
    """Call the launcher ``name`` of ``csrc/staged.cu`` on the current
    stream of ``device``; raise if the launch failed."""
    fn = getattr(build.load_library("staged"), name)
    fn.argtypes = _ARGTYPES[name]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream(device).cuda_stream
    with span("rdsp.launch", kernel=name):
        err = fn(*args, stream)
    if err:
        raise RuntimeError(f"{name} launch failed: cudaError {err}")


def fused_mix_filter_demod_plain(xr, xi, inc, phase0, w, tail, gain_i=1.0,
                                 gain_q=1.0):
    """Plain PyTorch version of ``fused_mix_filter_demod``."""
    _check_mix_demod(xr, xi, inc, phase0, w, tail)
    n = xr.shape[1]
    pos = torch.arange(n, dtype=torch.int64, device=xr.device)
    xr = xr * float(np.float32(gain_i))
    xi = xi * float(np.float32(gain_q))
    br, bi = mix(xr, xi, phase0, inc, pos)
    tr, ti = mix(tail[:, :BLOCK], tail[:, BLOCK:], phase0, inc, pos[:BLOCK] - BLOCK)
    return demod_frames(br, bi, tr, ti, w).reshape(xr.shape)


def fused_mix_filter_demod(xr, xi, inc, phase0, w, tail, gain_i=1.0, gain_q=1.0):
    """NCO mix + sideband filter + SSB demod of one segment.

      xr, xi:      (C, n) f32 planar IQ, unscaled
      inc, phase0: (C,) int64 DDS words in [0, 2^32)
      w:           (512, 128) ssb_demod_operator
      tail:        (C, 256) [re|im] the previous segment's last block, scaled
                   and not mixed (zeros at stream start)
      gain_i/q:    f32 gains of I and Q (input gain, input gain * balance)

    Returns the pre-AGC audio (C, n) f32. CPU tensors run the plain version
    (and build no image); CUDA tensors launch the kernel on w's ``mix_image``,
    or raise.
    """
    global LAUNCHES_MIX_DEMOD
    if xr.device.type == "cpu":
        return fused_mix_filter_demod_plain(xr, xi, inc, phase0, w, tail,
                                            gain_i, gain_q)
    if xr.device.type != "cuda":
        raise ValueError(f"fused_mix_filter_demod runs on cuda or cpu, not {xr.device}")
    _check_mix_demod(xr, xi, inc, phase0, w, tail)
    image = mix_image(w)
    check_image(image, xr.device)
    check_launch("fused_mix_filter_demod", (xr, xi, inc, phase0, w, tail))
    c, n = xr.shape
    audio = torch.empty_like(xr)
    launch("mix_demod", xr.device,
            *(t.data_ptr() for t in (xr, xi, inc, phase0, image, tail, audio)),
            c, n, xr.device.index or 0, float(np.float32(gain_i)),
            float(np.float32(gain_q)))
    LAUNCHES_MIX_DEMOD += 1
    return audio


def pbt_filter_plain(audio, w, tail, out_gain=1.0):
    """Plain PyTorch version of ``pbt_filter``."""
    _checkpbt_frames(audio, w, tail)
    c, n = audio.shape
    lr = pbt_frames(audio.view(c, n // BLOCK, BLOCK), tail, w) * float(np.float32(out_gain))
    return lr[..., :BLOCK].reshape(c, n), lr[..., BLOCK:].reshape(c, n)


def pbt_filter(audio, w, tail, out_gain=1.0):
    """PBT conv stage: audio (C, n) f32 -> (L, R), each (C, n).

    w: (256, 256) pbt_operator; tail: (C, 128) the previous segment's last
    audio block (zeros at stream start). CPU tensors run the plain version;
    CUDA tensors launch the kernel, or raise.
    """
    global LAUNCHES_PBT
    if audio.device.type == "cpu":
        return pbt_filter_plain(audio, w, tail, out_gain)
    if audio.device.type != "cuda":
        raise ValueError(f"pbt_filter runs on cuda or cpu, not {audio.device}")
    _checkpbt_frames(audio, w, tail)
    check_launch("pbt_filter", (audio, w, tail))
    c, n = audio.shape
    out_l, out_r = torch.empty_like(audio), torch.empty_like(audio)
    launch("pbt", audio.device,
            *(t.data_ptr() for t in (audio, w, tail, out_l, out_r)),
            c, n, audio.device.index or 0, float(np.float32(out_gain)))
    LAUNCHES_PBT += 1
    return out_l, out_r
