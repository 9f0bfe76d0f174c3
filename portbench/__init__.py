"""The benchmark of mugiq_tpu_torch, the PyTorch and CUDA port: seconds per
gauge configuration of the deflated disconnected loop on one H100
(``python3 -m portbench.run``; README.md)."""
