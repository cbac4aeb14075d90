"""Assemble model-ready KPCN training batches from raw sample dumps.

Counterpart of ``kpcn_batch_from_raw`` and the KPCN branch of
``synthetic_batch`` in ``wcmc_tpu/data/batches.py``: a raw
``(H, W, S, 104)`` dump + ``(H, W, 9)`` ground truth -> the
channels-last batch dict ``KPCNInterface`` takes.  Built on CPU tensors;
the interface moves a batch to its device.  The SBMC/LBMC batches come
with their ports.
"""

from __future__ import annotations

import numpy as np
import torch

from wcmc_tpu_torch.data import preprocess, synthetic


def kpcn_batch_from_raw(raw, gt, use_llpm_buf=False):
    """(H,W,S,104) + (H,W,9) -> single-example KPCN batch (B=1) of CPU
    tensors."""
    raw = preprocess.sanitize(torch.as_tensor(np.asarray(raw)))
    gt = preprocess.sanitize(torch.as_tensor(np.asarray(gt)))
    buf = preprocess.preprocess_kpcn(raw)
    batch = preprocess.kpcn_net_inputs(buf)
    batch.update(preprocess.kpcn_targets(gt))
    if use_llpm_buf:
        llpm = preprocess.preprocess_llpm(raw)
        pw = llpm[..., :1].mean(dim=2)
        batch["kpcn_diffuse_in"] = torch.cat([batch["kpcn_diffuse_in"], pw], dim=-1)
        batch["kpcn_specular_in"] = torch.cat([batch["kpcn_specular_in"], pw], dim=-1)
        # sample-space 'paths' is (S, H, W, 36) before batching
        batch["paths"] = llpm[..., 1:].permute(2, 0, 1, 3)
    return {k: v[None].contiguous() for k, v in batch.items()}


def _stack(dicts):
    return {k: torch.cat([d[k] for d in dicts], dim=0) for k in dicts[0]}


def synthetic_batch(rng: np.random.Generator, base_model: str, batch_size: int = 2,
                    patch: int = 32, spp: int = 4, use_llpm_buf: bool = False):
    """Model-ready random KPCN batch for tests and benchmarks (the same
    numpy draws as the reference's ``synthetic_batch``)."""
    if base_model != "kpcn":
        raise NotImplementedError(f"{base_model} batches are not ported yet")
    examples = []
    for _ in range(batch_size):
        raw, gt = synthetic.synthetic_raw_sample(rng, patch, patch, spp)
        examples.append(kpcn_batch_from_raw(raw, gt, use_llpm_buf))
    return _stack(examples)
