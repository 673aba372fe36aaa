"""The benchmark of radiodsp_sdr_rx_tpu_torch, the PyTorch and CUDA port:
one command runs one cell once (``python3 -m rxbench.run``; README.md)."""
