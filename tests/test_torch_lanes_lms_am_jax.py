"""The port's folded AM + notch + noise-blanker route against the JAX lanes
kernel in Pallas interpret mode (tests/lanes_jax_compare.py), on locked
carriers with decisive impulses and a warm-started average.

The JAX kernel computes the NLMS recurrence as a grouped macro with a
telescoped R (ops/pallas_lms.py:127, 230), the port one step per sample: the
same algebra, reassociated, so the bound is the LMS twin bound, 2e-4
(tests/test_pallas_lms.py:35). Measured: at most 1.1e-7 on the audio. The
JAX kernel walks 512-sample chunks, four a segment, so its LMS carries cross
chunk boundaries too; tracing its macro stream takes about a minute here
(twice that at the bank's default 2048), so this route has a file of its own
(a worker of its own under ``--dist loadfile``).
"""

from lanes_jax_compare import compare_with_jax_lanes

ATOL = 2e-4


def test_am_notch_blanker_matches_jax_lanes_kernel():
    assert compare_with_jax_lanes("lanes_am_notch_nb", ATOL, fold_chunk=512) <= ATOL
