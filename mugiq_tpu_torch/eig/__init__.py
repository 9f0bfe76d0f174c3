"""Eigensolver helpers (Chebyshev acceleration) and the Krylov-Schur
Arnoldi of the non-normal operators M / M^dag."""
