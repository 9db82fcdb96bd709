"""PyTorch + CUDA port of rectdetect_tpu for NVIDIA Hopper.

Plain tensor code is PyTorch; every kernel the JAX package wrote in
Pallas for the TPU becomes a hand-written CUDA kernel (csrc/), built with
nvcc at first use and bound with ctypes (ops/_build.py).  The package
imports neither jax nor rectdetect_tpu.

Ported so far: the poly path (pipeline.poly.poly_frame), the rect path
(pipeline.rect.rect_frame), the capacity calibration and its plan file
(runtime/), the native host runtime (runtime/native.py over
csrc/host/, built with g++), the stage dumps (utils/debug.py), the video
detectors (pipeline/video.py) and the apps.
"""
