"""``ShardedFusedBank`` and ``shard_channel_bank`` on the CPU: the port's
sharded banks against its unsharded banks and against the JAX package.

A channel=4 mesh over ``[torch.device("cpu")] * 4``: every shard runs its own
bank (the fused kernels' plain versions here), so each channel's result is
its unsharded bank's, bit for bit, over two threaded segments, for every
bank class ``_pick_cls`` picks (SSB sweep, AM, SAM folded, NR folded on the
lanes and spectral routes) and for ``ReceiverBank`` with DNR2. The per-channel
state leaves equal the unsharded bank's too. Against JAX (the 8 virtual CPU
devices, interpret-mode Pallas), as tests/test_scale.py:53-155 at tier-1
sizes: the SSB and AM ``ShardedFusedBank`` at the fused banks' bound 1e-4
(tests/test_torch_fused_bank.py) at 32 channels, the whole state included, and
``shard_channel_bank`` of an AM ``ReceiverBank`` at 1e-4. The JAX NR and SAM
sharded banks take minutes in interpret mode; the port's unsharded ones are
held to JAX in tests/test_torch_lanes_bank.py and tests/test_torch_sam_bank.py.
"""

import numpy as np
import pytest
import torch
import jax

from radiodsp_sdr_rx_tpu.models import config as jcfg
from radiodsp_sdr_rx_tpu.models.receiver import ReceiverBank as JaxReceiverBank
from radiodsp_sdr_rx_tpu import parallel as jpar
from radiodsp_sdr_rx_tpu_torch.models import config as tcfg
from radiodsp_sdr_rx_tpu_torch.models import fused
from radiodsp_sdr_rx_tpu_torch.models.receiver import ReceiverBank
from radiodsp_sdr_rx_tpu_torch.parallel import ShardedFusedBank, make_mesh, shard_channel_bank
from radiodsp_sdr_rx_tpu_torch.utils import convert

CENTER = 7_050_000.0
N_CH, N = 16, 1024
CPU4 = [torch.device("cpu")] * 4

CASES = {   # name: (mode, nr, agc, bank class)
    "usb": ("USB", "OFF", "MEDIUM", fused.FusedSSBBank),
    "am": ("AM", "OFF", "MEDIUM", fused.FusedAMBank),
    "sam": ("SAM", "OFF", "MEDIUM", fused.FusedSAMBank),
    "usb_dnr2": ("USB", "DNR2", "MEDIUM", fused.FusedNRBank),
    "usb_spec2": ("USB", "SPEC2", "FAST", fused.FusedNRBank),
}


def _cfg(pkg, name):
    mode, nr, agc, _ = CASES[name]
    return pkg.ReceiverConfig(mode=pkg.DemodMode[mode], nr=pkg.NRMode[nr],
                              agc=pkg.AGCMode[agc], vfo_freq=CENTER, capture_center_freq=CENTER)


def _freqs(c=N_CH):
    return [CENTER - 8_000.0 + 500.0 * k for k in range(c)]


def _planes(seed, c=N_CH):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, c, 2 * N)).astype(np.float32) * 0.1
    x[0, :, 300:400] *= 20.0
    return x[0], x[1]


def _per_channel(state, c):
    """The leaves with one row per channel (the padded LMS/PLL rows differ)."""
    return {k: v for k, v in state._asdict().items() if v.dim() and v.shape[0] == c}


@pytest.mark.parametrize("name", sorted(CASES))
def test_sharded_fused_bank_equals_unsharded_bank_bit_for_bit(name):
    cfg = _cfg(tcfg, name)
    sharded = ShardedFusedBank(cfg, _freqs(), make_mesh(channel=4, devices=CPU4))
    assert type(sharded.template) is CASES[name][3]
    one = CASES[name][3](cfg, _freqs(), device="cpu")
    xr, xi = _planes(1)
    st, ost = sharded.init_state(), one.init_state()
    for seg in range(2):
        part = slice(seg * N, (seg + 1) * N)
        got, st = sharded.process_planar(xr[:, part], xi[:, part], st)
        want, ost = one.process_planar(xr[:, part], xi[:, part], ost)
        for key in ("audio_l", "audio_r"):
            assert got[key].shape == (N_CH, N) and torch.equal(got[key], want[key]), key
        gs, ws = _per_channel(st, N_CH), _per_channel(ost, N_CH)
        assert gs.keys() == ws.keys()
        for k in gs:
            assert torch.equal(gs[k], ws[k]), k


@pytest.mark.parametrize("name", ["usb", "am"])
def test_sharded_fused_bank_matches_jax(name):
    """32 channels: the JAX kernels take 8 channels a block, 8 a shard."""
    xr, xi = _planes(2, 32)
    jbank = jpar.ShardedFusedBank(_cfg(jcfg, name), _freqs(32), jpar.make_mesh(channel=4),
                                  interpret=True)
    port = ShardedFusedBank(_cfg(tcfg, name), _freqs(32), make_mesh(channel=4, devices=CPU4))
    np.testing.assert_array_equal(port.incs, jbank.incs)
    jst, st = jbank.init_state(), port.init_state()
    for seg in range(2):
        part = slice(seg * N, (seg + 1) * N)
        want, jst = jbank.process_planar(xr[:, part], xi[:, part], jst)
        got, st = port.process_planar(xr[:, part], xi[:, part], st)
        for key in ("audio_l", "audio_r"):
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-4,
                                       rtol=0)
        d = convert.state_to_numpy(st)
        for k, v in jst._asdict().items():
            np.testing.assert_allclose(d[k], np.asarray(v), atol=1e-4, rtol=1e-4, err_msg=k)


def test_shard_channel_bank_matches_unsharded_and_jax():
    """An AM ReceiverBank split over 4 shards; DNR2 too (each shard's LMS
    stage its own bank of 4 channels)."""
    freqs = _freqs()[:8]
    xr, xi = _planes(3)
    iq = (xr[:8] + 1j * xi[:8]).astype(np.complex64)
    for name in ("am", "usb_dnr2"):
        bank = ReceiverBank(_cfg(tcfg, name), freqs, device="cpu")
        process = shard_channel_bank(bank, make_mesh(channel=4, devices=CPU4))
        got, st = process(iq, bank.init_state())
        want, wst = bank.process(iq, bank.init_state())
        for key in ("audio_l", "audio_r"):
            assert got[key].shape == (8, 2 * N) and torch.equal(got[key], want[key]), key
        flat = jax.tree_util.tree_leaves
        assert all(torch.equal(a, b) for a, b in zip(flat(tuple(st)), flat(tuple(wst))))
    jbank = JaxReceiverBank(_cfg(jcfg, "am"), freqs)
    jout, _ = jpar.shard_channel_bank(jbank, jpar.make_mesh(channel=4))(iq, jbank.init_state())
    bank = ReceiverBank(_cfg(tcfg, "am"), freqs, device="cpu")
    got, _ = shard_channel_bank(bank, make_mesh(channel=4, devices=CPU4))(iq, bank.init_state())
    np.testing.assert_allclose(got["audio_l"].numpy(), np.asarray(jout["audio_l"]), atol=1e-4,
                               rtol=0)


def test_sharded_banks_refuse_uneven_splits():
    mesh = make_mesh(channel=4, devices=CPU4)
    with pytest.raises(ValueError, match="not divisible"):
        ShardedFusedBank(_cfg(tcfg, "usb"), _freqs()[:6], mesh)
    with pytest.raises(ValueError, match="not divisible"):
        shard_channel_bank(ReceiverBank(_cfg(tcfg, "usb"), _freqs()[:6], device="cpu"), mesh)
