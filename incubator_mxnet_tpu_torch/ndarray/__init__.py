"""nd namespace — MXNet-named operators on ``torch.Tensor``."""
from .ndarray import *  # noqa: F401,F403
