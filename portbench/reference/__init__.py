"""The plain reference of the benchmark's correctness check: plain PyTorch
and NumPy on complex full-site fields.  It imports nothing of the program
(``mugiq_tpu_torch``), of the JAX package or of JAX, and takes nothing the
program has made: it builds its operators from the gauge and the seeds and
reads the program's outputs only to judge them."""
