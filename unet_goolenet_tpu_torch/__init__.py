"""PyTorch + CUDA port of the two-stage breast-ultrasound grader.

The serving path of `unet_goolenet_tpu` (gray -> wavelet -> resize -> UNet ->
mask -> bbox crop -> GoogLeNet -> grade) on stock PyTorch, with the UNet's
last decoder level (up1 + the 1x1 head) on two hand-written CUDA kernels
(`ops/kernels/up1.py`, `csrc/`). Module paths mirror the JAX package, so each
counterpart is found by name. Public functions keep the JAX package's NHWC
layout; the `nn.Module`s carry the reference's torch parameter names, so
reference checkpoints load with `load_state_dict` and no converter.

This package imports torch, numpy and PIL, never jax.
"""
