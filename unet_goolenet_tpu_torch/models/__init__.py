"""The port's models, with the reference's torch parameter names."""

from unet_goolenet_tpu_torch.models.convert import (
    gnet_from_jax, load_reference_state_dict, unet_from_jax, unet_to_jax)
from unet_goolenet_tpu_torch.models.googlenet import GoogLeNetClassifier
from unet_goolenet_tpu_torch.models.unet import UNetTaskAligWeight

__all__ = ["GoogLeNetClassifier", "UNetTaskAligWeight", "gnet_from_jax",
           "load_reference_state_dict", "unet_from_jax", "unet_to_jax"]
