"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

K1 :func:`wilson.wilson_m`, K2 :func:`contract.loop_contract`,
K3 :func:`contract.covariant_displace`, K6 :func:`parity.parity_hop`.
Each wrapper counts its kernel launches in a ``launches`` attribute.
"""
