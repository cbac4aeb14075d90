"""Models: the KPCN, SBMC and LBMC backbones, PathNet and their building
blocks."""

from wcmc_tpu_torch.models.kpcn import KPCN  # noqa: F401
from wcmc_tpu_torch.models.lbmc import LayerNet  # noqa: F401
from wcmc_tpu_torch.models.pathnet import PathNet  # noqa: F401
from wcmc_tpu_torch.models.sbmc import Multisteps  # noqa: F401
