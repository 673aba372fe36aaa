"""The AM chain's choice of blocks per channel, on the CPU.

``ops/sweep.launch_chain`` runs K1's AM kernels (``sweep_chain_am``,
``sweep_chain_am_nb``) on a cluster of two blocks per channel whenever the
card holds a cluster for every channel at once, else on one block per
channel. The choice is ``sweep.am_cluster_size``, a pure function of the
channel count and the card's count of such clusters (66 on an H100 SXM:
132 SMs in pairs), which ``sweep.am_active_clusters`` asks the card once.
A forced size (``_split``) is for the card tests and ``chip_smoke.py``,
which compare the two forms; only 1 and 2 are taken. The forms themselves
are held to each other bit for bit on the card
(``tests/test_torch_kernels_cuda.py``).
"""

import types

import pytest
import torch

from radiodsp_sdr_rx_tpu_torch.ops import sweep
from radiodsp_sdr_rx_tpu_torch.utils import build


@pytest.mark.parametrize("channels, clusters, want", [
    (64, 66, 2),     # config1's bank on an H100: 128 of 132 SMs
    (66, 66, 2),     # every cluster the card holds
    (67, 66, 1),     # one channel too many: one block a channel
    (128, 66, 1),
    (1, 66, 2),
    (1, 0, 1),       # a card that holds no such cluster
])
def test_cluster_size_from_channels(channels, clusters, want):
    assert sweep.am_cluster_size(channels, clusters) == want


@pytest.mark.parametrize("channels, split", [(128, 2), (64, 1), (1, 1)])
def test_forced_size_wins(channels, split):
    assert sweep.am_cluster_size(channels, 66, split) == split


@pytest.mark.parametrize("split", [0, 3, 4, -1])
def test_forced_size_refused(split):
    with pytest.raises(ValueError, match="1 or 2 blocks"):
        sweep.am_cluster_size(64, 66, split)


def _am_args(c=3, n=384, nb=False):
    gen = torch.Generator().manual_seed(c * n + nb)
    r = lambda *s: torch.randn(s, generator=gen) * 0.1   # noqa: E731
    args = [r(c, n), r(c, n), torch.arange(c, dtype=torch.int64) * 97,
            torch.arange(c, dtype=torch.int64) * 7, r(512, 256), r(256, 256), r(c, 128),
            r(c, 128), r(c, 128), torch.full((c,), 0.05), torch.zeros(c, 2), 0.999, 0.2, 100.0]
    if nb:   # agc_enabled, out gain, the gains, then the blanker's
        args += [True, 1.0, 1.0, 1.0, True, 10.0, 512.0, torch.full((c,), 0.1),
                 torch.ones(c, 128)]
    return args


@pytest.mark.parametrize("split", [0, 3])
@pytest.mark.parametrize("nb", [False, True])
def test_am_chain_refuses_other_sizes(split, nb):
    with pytest.raises(ValueError, match="1 or 2 blocks"):
        sweep.sweep_am_chain(*_am_args(nb=nb), _split=split)


@pytest.mark.parametrize("split", [1, 2])
@pytest.mark.parametrize("nb", [False, True])
def test_forced_size_on_cpu_runs_the_plain_chain(split, nb):
    """CPU tensors run the plain version whatever the size, and launch nothing."""
    args = _am_args(nb=nb)
    before = (sweep.LAUNCHES_AM, sweep.LAUNCHES_AM_NB)
    got = sweep.sweep_am_chain(*args, _split=split)
    want = sweep.sweep_am_chain_plain(*args)
    assert len(got) == len(want) == (7 if nb else 5)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert (sweep.LAUNCHES_AM, sweep.LAUNCHES_AM_NB) == before


def _library(answer, calls):
    """A stand-in for the built sweep_chain library that records its queries."""
    def am_pair_clusters(nb, device):
        calls.append((nb, device))
        return answer
    return types.SimpleNamespace(am_pair_clusters=am_pair_clusters)


def test_active_clusters_asked_once_per_device_and_blanker(monkeypatch):
    calls = []
    monkeypatch.setattr(build, "load_library", lambda name: _library(66, calls))
    monkeypatch.setattr(sweep, "_AM_CLUSTERS", {})
    dev = torch.device("cuda", 1)
    assert [sweep.am_active_clusters(dev, nb) for nb in (False, True, False, True)] == [66] * 4
    assert calls == [(0, 1), (1, 1)]


def test_active_clusters_query_failure_raises(monkeypatch):
    monkeypatch.setattr(build, "load_library", lambda name: _library(-2, []))
    monkeypatch.setattr(sweep, "_AM_CLUSTERS", {})
    with pytest.raises(RuntimeError, match="cudaError 2"):
        sweep.am_active_clusters(torch.device("cuda", 0), False)
