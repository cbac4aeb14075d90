"""Shared helpers."""

from wcmc_tpu_torch.utils.utils import (
    crop_like,
    linear_to_srgb,
    tonemap_batch,
    tonemap_reinhard,
    tonemap_reinhard_lum,
)
