"""Assemble model-ready training batches from raw sample dumps.

Counterpart of ``wcmc_tpu/data/batches.py``: a raw ``(H, W, S, 104)``
dump + ``(H, W, 9)`` ground truth -> the channels-last batch dict that
``KPCNInterface`` (pixel space) or ``SBMCInterface`` / ``LBMCInterface``
(sample space) takes.  Built on CPU tensors; the interface moves a batch
to its device.
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


def sbmc_batch_from_raw(raw, gt, use_g_buf=True, use_sbmc_buf=True, use_llpm_buf=False):
    """(H,W,S,104) + (H,W,9) -> single-example SBMC/LBMC batch (B=1) of
    CPU tensors: 'radiance' and 'features' (S, H, W, C) per example, and
    with ``use_llpm_buf`` the per-sample path weight as the last feature
    and the 36-ch 'paths'."""
    raw = preprocess.sanitize(torch.as_tensor(np.asarray(raw)))
    gt = preprocess.sanitize(torch.as_tensor(np.asarray(gt)))
    s_buf, p_buf = preprocess.preprocess_sbmc(raw)
    d = preprocess.sbmc_features(s_buf, p_buf if use_sbmc_buf else None, use_g_buf,
                                 use_sbmc_buf)
    batch = {
        "radiance": d["radiance"].permute(2, 0, 1, 3),
        "features": d["features"].permute(2, 0, 1, 3),
        "target_image": gt[..., :3],
    }
    if use_llpm_buf:
        llpm = preprocess.preprocess_llpm(raw)
        batch["features"] = torch.cat([batch["features"], llpm[..., :1].permute(2, 0, 1, 3)],
                                      dim=-1)
        batch["paths"] = llpm[..., 1:].permute(2, 0, 1, 3)
    return {k: v[None].contiguous() for k, v in batch.items()}


def _stack(dicts):
    return {k: torch.cat([d[k] for d in dicts], dim=0) for k in dicts[0]}


def synthetic_batch(rng: np.random.Generator, base_model: str, batch_size: int = 2,
                    patch: int = 32, spp: int = 4, use_llpm_buf: bool = False,
                    use_sbmc_buf: bool = True):
    """Model-ready random batch for tests and benchmarks (the same numpy
    draws as the reference's ``synthetic_batch``); the path buffer joins
    the features for SBMC only."""
    if base_model not in ("kpcn", "sbmc", "lbmc"):
        raise ValueError(f"unknown base model {base_model!r}")
    examples = []
    for _ in range(batch_size):
        raw, gt = synthetic.synthetic_raw_sample(rng, patch, patch, spp)
        if base_model == "kpcn":
            examples.append(kpcn_batch_from_raw(raw, gt, use_llpm_buf))
        else:
            examples.append(sbmc_batch_from_raw(
                raw, gt, use_sbmc_buf=use_sbmc_buf and base_model == "sbmc",
                use_llpm_buf=use_llpm_buf))
    return _stack(examples)
