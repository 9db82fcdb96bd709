"""PyTorch + CUDA port of rectdetect_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas for the TPU becomes a hand-written CUDA kernel (csrc/), built with
nvcc at first use and bound with ctypes (ops/_build.py).  The package
imports neither jax nor rectdetect_tpu.

Slice ported so far: the poly path, pipeline.poly.poly_frame.
"""
