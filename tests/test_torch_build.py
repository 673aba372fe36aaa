"""The kernel build's cache key: ``utils/build.py`` names a library by a hash
of its ``.cu`` source, of every ``csrc/`` header it includes and of the nvcc
flags, so that an edited shared header rebuilds every library that uses it.
Nothing here runs nvcc."""

import shutil

import pytest

from radiodsp_sdr_rx_tpu_torch.utils import build


CHAIN = ["sweep_chain.cuh", "chain_args.cuh", "chain_common.cuh", "lms_step.cuh", "sam_pll.cuh"]
HEADERS = {"sweep_chain": CHAIN, "sweep_denoise": CHAIN, "sweep_notch": CHAIN,
           "sweep_spec": CHAIN, "staged": ["chain_common.cuh"], "lms": ["lms_step.cuh"],
           "sam": ["sam_pll.cuh"],
           "sam_wide": ["chain_args.cuh", "chain_common.cuh", "sam_pll.cuh"]}


@pytest.mark.parametrize("name", sorted(HEADERS))
def test_sources_follow_includes(name):
    assert [p.name for p in build.sources(name)] == [f"{name}.cu", *HEADERS[name]]


@pytest.mark.parametrize("edited", ["staged.cu", "chain_common.cuh", "sweep_chain.cu",
                                    "sam_pll.cuh", "lms_step.cuh", "sweep_chain.cuh",
                                    "chain_args.cuh"])
def test_artifact_changes_with_each_source(tmp_path, monkeypatch, edited):
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    monkeypatch.setattr(build, "CSRC", csrc)
    names = ("staged", "sweep_chain", "lms", "sweep_notch")
    before = {name: build._artifact(name).name for name in names}
    (csrc / edited).write_text((csrc / edited).read_text() + "\n// edited\n")
    after = {name: build._artifact(name).name for name in names}
    for name in before:
        uses = edited in [p.name for p in build.sources(name)]
        assert (before[name] != after[name]) == uses, name


def test_nested_headers_are_followed(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "a.cuh"\n#include <cuda_runtime.h>\n')
    (csrc / "a.cuh").write_text('#pragma once\n#include "b.cuh"\n')
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n')
    monkeypatch.setattr(build, "CSRC", csrc)
    assert [p.name for p in build.sources("k")] == ["k.cu", "a.cuh", "b.cuh"]
    before = build._artifact("k").name
    (csrc / "b.cuh").write_text('#pragma once\n#include "a.cuh"\n// edited\n')
    assert build._artifact("k").name != before
