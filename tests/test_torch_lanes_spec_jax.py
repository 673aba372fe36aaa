"""The port's folded spectral-NR routes against the JAX lanes kernel.

Each of the five spectral instantiations of the lanes kernel (SSB with the
blanker; AM and SAM with and without it) through the port's
``FusedNRBank(fold=True)`` on the CPU against the JAX bank's
``sweep_lanes_chain`` in Pallas interpret mode, as tests/lanes_jax_compare.py
sets out: <= 1e-4, the sweep chains' bound (both f32; the products, the
floor's row scan and the AGC run in another order, and the AGC gain
amplifies that). Measured: at most 2.2e-7 on the audio.
"""

import pytest

from lanes_jax_compare import compare_with_jax_lanes

ATOL = 1e-4


@pytest.mark.parametrize("route", ["lanes_ssb_spectral_nb", "lanes_am_spectral",
                                   "lanes_am_spectral_nb", "lanes_sam_spectral",
                                   "lanes_sam_spectral_nb"])
def test_spectral_route_matches_jax_lanes_kernel(route):
    assert compare_with_jax_lanes(route, ATOL) <= ATOL
