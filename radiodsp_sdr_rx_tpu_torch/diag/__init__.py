"""Card-side diagnostics of the port's kernels, run by hand on a CUDA card:
``compare_builds`` (every chain route of two checkouts, bit for bit) and
``warp_layouts`` (the PLL kernels under other warp layouts of their block)."""
