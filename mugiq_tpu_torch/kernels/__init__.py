"""Hand-written CUDA kernels for Hopper and their plain PyTorch twins.

K1 :func:`wilson.wilson_m`, K2 :func:`contract.loop_contract`,
K3 :func:`contract.covariant_displace`, K5 :func:`hop_dir.dslash_hop_dir`,
K6 :func:`parity.parity_hop`, and the halo-extended forms of K1 and K6 on
one rank's block, K7a :func:`wilson.wilson_m_halo` and
K7b :func:`parity.parity_hop_halo`.
Each wrapper counts its kernel launches in a ``launches`` attribute.
"""
