"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (used for CPU tensors and as the kernel's oracle). Importing the
package registers the serving kernels' custom ops (`library.py`), which
their wrappers call."""

from unet_goolenet_tpu_torch.ops.kernels import library  # noqa: F401  (registers ugt::*)
