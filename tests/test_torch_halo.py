"""The ring halo K9 (``parallel/halo.py``) on the CPU vs the JAX package.

On the CPU the wrappers run their plain versions (list copies). Each is held
bit for bit, on an 8-shard time line, f32 and complex64, to the JAX halos on
the 8 virtual CPU devices of tests/conftest.py: ``_shift_from_left`` (the
ppermute) and ``shift_from_left_pallas`` and ``ring_shift_right_pallas``
(the Pallas kernel in the Mosaic interpreter, remote DMAs and the barrier
simulated), as tests/test_parallel.py:326-374 holds them to each other. The
one-card launch's host side (its table, one allocation an exchange) runs
on a stand-in for the C entry; the CUDA launch and its count are in
tests/test_torch_kernels_cuda.py.
"""

import ctypes
import struct

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp
from jax import shard_map
from jax.sharding import PartitionSpec as P

from radiodsp_sdr_rx_tpu.parallel import make_mesh as jax_make_mesh
from radiodsp_sdr_rx_tpu.parallel.pallas_halo import (
    ring_shift_right_pallas, shift_from_left_pallas)
from radiodsp_sdr_rx_tpu.parallel.stream_shard import _shift_from_left as jax_shift
from radiodsp_sdr_rx_tpu_torch.parallel import collectives, halo
from radiodsp_sdr_rx_tpu_torch.parallel.stream_shard import sharded_overlap_save

S, N_LOC, HALF = 8, 1024, 128


def _stream(dtype, seed):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, S * N_LOC)).astype(np.float32)
    return (x[0] + 1j * x[1]).astype(np.complex64) if dtype == "complex64" else x[0]


def _jax_halo(fn, x, first):
    mesh = jax_make_mesh(channel=1, time=S)

    def local(xl):
        return fn(xl[..., -HALF:], "time", first)

    return np.asarray(jax.jit(shard_map(local, mesh=mesh, in_specs=P(None, "time"),
                                        out_specs=P(None, "time"), check_vma=False))(
        x[None, :]))[0]


def _tails(x):
    return [torch.from_numpy(s[-HALF:].copy()) for s in np.split(x, S)]


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_shift_from_left_equals_jax_bit_for_bit(dtype):
    x = _stream(dtype, 3)
    first = np.full(HALF, 7.5, x.dtype)
    got = torch.cat(halo.shift_from_left_kernel(_tails(x), torch.from_numpy(first))).numpy()
    plain = torch.cat(halo.shift_from_left_plain(_tails(x), torch.from_numpy(first))).numpy()
    assert np.array_equal(got, plain) and np.array_equal(got[:HALF], first)
    for fn in (jax_shift, shift_from_left_pallas):
        want = _jax_halo(fn, x, jnp.asarray(first))
        assert got.dtype == want.dtype and np.array_equal(got, want), fn.__name__


@pytest.mark.parametrize("dtype", ["float32", "complex64"])
def test_ring_shift_right_equals_jax_bit_for_bit(dtype):
    """The ring wraps: shard 0 receives the last shard's block. The JAX
    kernel takes f32 (…, lanes) blocks; complex crosses as its two planes."""
    x = _stream(dtype, 4)
    got = torch.cat(halo.ring_shift_right(_tails(x))).numpy()
    planes = [x] if dtype == "float32" else [x.real.copy(), x.imag.copy()]
    outs = []
    for p in planes:
        mesh = jax_make_mesh(channel=1, time=S)
        outs.append(np.asarray(jax.jit(shard_map(
            lambda xl: ring_shift_right_pallas(xl[..., -HALF:], "time"), mesh=mesh,
            in_specs=P(None, "time"), out_specs=P(None, "time"), check_vma=False))(
            p[None, :]))[0])
    want = outs[0] if dtype == "float32" else (outs[0] + 1j * outs[1]).astype(np.complex64)
    assert np.array_equal(got, want)
    assert np.array_equal(got[:HALF], x[-HALF:])


def test_bank_tails_and_kernel_route_of_the_overlap_save():
    """(C_loc, 128) bank tails shift row for row, first_tail broadcast; the
    overlap-save with halo="kernel" (the plain copies on the CPU) equals the
    ppermute halo bit for bit."""
    rng = np.random.default_rng(5)
    blocks = [torch.from_numpy(rng.standard_normal((4, HALF)).astype(np.float32))
              for _ in range(S)]
    out = halo.shift_from_left_kernel(blocks, torch.zeros(HALF))
    assert all(torch.equal(o, b) for o, b in zip(out[1:], blocks[:-1]))
    assert out[0].shape == (4, HALF) and not out[0].any()
    axis = collectives.LocalAxis([torch.device("cpu")] * S)
    xs = [torch.from_numpy((rng.standard_normal((3, 512)) + 1j * rng.standard_normal((3, 512)))
                           .astype(np.complex64)) for _ in range(S)]
    w = torch.from_numpy(rng.standard_normal((512, 256)).astype(np.float32))
    first = torch.zeros(3, HALF, dtype=torch.complex64)
    a, ta = sharded_overlap_save(xs, w, first, axis, halo="kernel")
    b, tb = sharded_overlap_save(xs, w, first, axis, halo="ppermute")
    assert all(torch.equal(u, v) for u, v in zip(a + ta, b + tb))


def test_rings_of_several_lines_shift_each_on_its_own():
    """Two lines of four shards in one list (``ring=4``, an in-process
    channel=2 x time=4 mesh): each ring wraps within itself, and each ring's
    first shard takes its own first tail."""
    blocks = [torch.full((2, HALF), float(s)) for s in range(8)]
    got = halo.ring_shift_right(blocks, ring=4)
    assert [int(g[0, 0]) for g in got] == [3, 0, 1, 2, 7, 4, 5, 6]
    firsts = [torch.full((HALF,), -1.0), torch.full((HALF,), -2.0)]
    got = halo.shift_from_left_kernel(blocks, firsts, ring=4)
    assert [int(g[0, 0]) for g in got] == [-1, 0, 1, 2, -2, 4, 5, 6]
    axis = collectives.LocalAxis([torch.device("cpu")] * 8, 4)
    assert axis.indices == [0, 1, 2, 3] * 2
    gathered = axis.all_gather(blocks)
    assert [int(g[:, 0, 0].sum()) for g in gathered] == [6] * 4 + [22] * 4
    with pytest.raises(ValueError, match="whole number of rings"):
        halo.ring_shift_right(blocks, ring=3)
    with pytest.raises(ValueError, match="first tails for"):
        halo.shift_from_left_kernel(blocks, firsts[:1], ring=4)


def test_arguments_the_ring_refuses():
    f = torch.zeros(2, HALF)
    with pytest.raises(ValueError, match="at least one shard"):
        halo.ring_shift_right([])
    with pytest.raises(ValueError, match="f32 or complex64"):
        halo.ring_shift_right([torch.zeros(2, HALF, dtype=torch.float64)] * 2)
    with pytest.raises(ValueError, match="every block"):
        halo.ring_shift_right([f, torch.zeros(3, HALF)])
    with pytest.raises(ValueError, match="every block"):
        halo.shift_from_left_kernel([f, f.to(torch.complex64)], f)
    with pytest.raises(ValueError, match="cuda or cpu"):
        halo.ring_shift_right([torch.zeros(2, HALF, device="meta")] * 2)
    with pytest.raises(ValueError, match="halo must be"):
        sharded_overlap_save([f], torch.zeros(256, 128), f, None, halo="pallas")


class _OnCard(torch.Tensor):
    """A CPU tensor that says it is on a card, to reach the launch's host side."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64])
def test_one_card_launch_table_is_the_plain_shift(dtype, monkeypatch):
    """The host side of the one-card launch (``ring_shift``): one table of
    source pointers, destination p the p-th block of one new allocation.
    A stand-in for the C entry copies by that table; the per-shard views it
    hands back equal the plain shifts, one launch an exchange, two rings of
    four included."""
    calls = []

    def shift(srcs, dsts, pairs, floats, device, stream):
        calls.append((pairs, floats))
        dsts = struct.unpack(f"{pairs}Q", dsts)
        assert all(d == dsts[0] + p * floats * 4 for p, d in enumerate(dsts))
        for src, dst in zip(struct.unpack(f"{pairs}Q", srcs), dsts):
            ctypes.memmove(dst, src, floats * 4)
        return 0

    monkeypatch.setattr(halo, "_library", lambda: {"ring_shift": shift})
    monkeypatch.setattr(halo, "_raw_stream", lambda index: 0)
    rng = np.random.default_rng(11)
    plain = [torch.from_numpy(rng.standard_normal((3, 5)).astype(np.float32)).to(dtype)
             for _ in range(8)]
    blocks = [b.as_subclass(_OnCard) for b in plain]
    firsts = [torch.full((5,), 2.0, dtype=dtype), torch.full((5,), -3.0, dtype=dtype)]
    before = halo.LAUNCHES
    got = [halo.ring_shift_right(blocks), halo.ring_shift_right(blocks, ring=4),
           halo.shift_from_left_kernel(blocks, firsts, ring=4)]
    want = [halo.ring_shift_right_plain(plain), halo.ring_shift_right_plain(plain, ring=4),
            halo.shift_from_left_plain(plain, firsts, ring=4)]
    assert halo.LAUNCHES - before == 3
    assert calls == [(8, 15 * (2 if dtype == torch.complex64 else 1))] * 3
    for g, w in zip(got, want):
        assert all(torch.equal(a.as_subclass(torch.Tensor), b) for a, b in zip(g, w))
        assert len({a.untyped_storage().data_ptr() for a in g}) == 1   # one allocation
    with pytest.raises(ValueError, match="contiguous"):
        halo.ring_shift_right([b.t() for b in blocks])
