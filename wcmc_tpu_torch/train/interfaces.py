"""Model interfaces: the contract between entry points and models.

Counterpart of the forward (validation / serving) part of
``wcmc_tpu/train/interfaces.py`` for KPCN: ``preprocess``,
``validate_batch`` and ``to_eval_mode`` with the same batch-dict keys,
the dual PathNet with its fused sample moments, the ddof=1 variance
feature and the disentanglement modes.  The models hold their own
parameters (``restore_interface`` loads checkpoints into them).  The
train step, the optimizers and the SBMC/LBMC interfaces come with later
parts of the port.

Layouts are channels-last: pixel ``(B,H,W,C)``, sample ``(B,S,H,W,C)``.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply
from wcmc_tpu_torch.utils.utils import crop_like

Batch = Dict[str, torch.Tensor]

DISENTANGLE_MODES = ("m11r11", "m10r01", "m11r01", "m10r11")


def split_disentangle(p_buffer, mode: str, axis: int = -1):
    """Split an embedding into (manifold half, reconstruction half)
    along the channel axis."""
    half = p_buffer.shape[axis] // 2
    lo = p_buffer.narrow(axis, 0, half)
    hi = p_buffer.narrow(axis, half, p_buffer.shape[axis] - half)
    if mode == "m11r11":
        return p_buffer, p_buffer
    if mode == "m10r01":
        return hi, lo
    if mode == "m11r01":
        return p_buffer, lo
    if mode == "m10r11":
        return hi, p_buffer
    raise ValueError(f"unknown disentangle mode {mode!r}")


class KPCNInterface:
    """Diffuse/specular KPCN with the optional dual PathNet, forward
    only."""

    REQUIRED_KEYS = (
        "target_total", "target_diffuse", "target_specular",
        "kpcn_diffuse_in", "kpcn_specular_in",
        "kpcn_diffuse_buffer", "kpcn_specular_buffer", "kpcn_albedo",
    )

    def __init__(self, models: Dict[str, torch.nn.Module],
                 loss_funcs: Dict[str, Callable], device, args=None,
                 use_llpm_buf: bool = False,
                 disentanglement_option: str = "m11r11"):
        if "dncnn" not in models:
            raise ValueError("KPCNInterface needs a 'dncnn' model")
        if use_llpm_buf and not {"backbone_diffuse", "backbone_specular"} <= set(models):
            raise ValueError("use_llpm_buf needs backbone_diffuse/backbone_specular")
        if "l_test" not in loss_funcs:
            raise ValueError("KPCNInterface needs an 'l_test' loss")
        if disentanglement_option not in DISENTANGLE_MODES:
            raise ValueError(f"unknown disentangle mode {disentanglement_option!r}")
        self.models = models
        self.loss_funcs = loss_funcs
        self.device = torch.device(device)
        self.args = args
        self.use_llpm_buf = use_llpm_buf
        self.disentanglement_option = disentanglement_option
        self.iters = 0
        self.best_err = 1e10
        self.m_losses: Dict[str, torch.Tensor] = {}
        self._val_step = self._make_val_step()

    def __str__(self):
        return "KPCNInterface"

    def preprocess(self, batch: Batch = None):
        for k in self.REQUIRED_KEYS:
            if k not in batch:
                raise KeyError(f"batch is missing key {k!r}")
        if self.use_llpm_buf and "paths" not in batch:
            raise KeyError("batch is missing key 'paths'")
        self.iters += 1

    def to_eval_mode(self):
        for m in self.models.values():
            m.eval()
        self.m_losses["m_val"] = torch.zeros((), device=self.device)

    def _dual_pathnet_with_moments(self, batch, cmajor=False):
        """Dual PathNet forward plus per-branch sample moments.

        Returns (p_d, p_s, mean_d, mean_s, var_d, var_s) where mean/var
        are full-channel (B,H,W,outc) f32 over the sample axis, from the
        head kernel's sum and sum of squares: the variance is
        ``max(ssq/S - mean^2, 0) * S/(S-1)`` (unbiased, ddof=1)."""
        p_d, p_s, (ssum, ssq) = dual_pathnet_apply(
            self.models["backbone_diffuse"], self.models["backbone_specular"],
            batch, with_moments=True, cmajor=cmajor,
        )
        s = p_d.shape[1]
        outc = p_d.shape[2] if cmajor else p_d.shape[-1]
        mean = ssum / s
        var = torch.clamp(ssq / s - mean * mean, min=0.0) * (s / max(s - 1, 1))
        return (p_d, p_s, mean[..., :outc], mean[..., outc:],
                var[..., :outc], var[..., outc:])

    @staticmethod
    def _variance_feature(var_slice, s):
        """(B,H,W,C) per-channel sample variance -> the (B,H,W,1)
        variance/spp input feature."""
        return var_slice.mean(dim=-1, keepdim=True) / s

    def _make_val_step(self):
        lf = self.loss_funcs
        dncnn = self.models["dncnn"]

        @torch.inference_mode()
        def step(batch):
            p_buffers = None
            net_batch = batch
            if self.use_llpm_buf:
                p_d, p_s, mean_d, mean_s, var_d, var_s = (
                    self._dual_pathnet_with_moments(batch)
                )
                s = p_d.shape[1]
                if self.disentanglement_option in ("m10r01", "m11r01"):
                    c = p_d.shape[-1]
                    p_d, p_s = p_d[..., :c // 2], p_s[..., :c // 2]
                    mean_d, mean_s = mean_d[..., :c // 2], mean_s[..., :c // 2]
                    var_d, var_s = var_d[..., :c // 2], var_s[..., :c // 2]
                p_buffers = {"diffuse": p_d, "specular": p_s}
                net_batch = dict(batch)
                net_batch["kpcn_diffuse_in"] = torch.cat(
                    [batch["kpcn_diffuse_in"], mean_d,
                     self._variance_feature(var_d, s)], dim=-1,
                )
                net_batch["kpcn_specular_in"] = torch.cat(
                    [batch["kpcn_specular_in"], mean_s,
                     self._variance_feature(var_s, s)], dim=-1,
                )
            out = dncnn(net_batch)
            tgt_total = crop_like(batch["target_total"], out["radiance"])
            l_test = lf["l_test"](out["radiance"], tgt_total)
            return out["radiance"], p_buffers, l_test

        return step

    def to_device(self, batch) -> Batch:
        """Numpy arrays or tensors -> tensors on this interface's device."""
        return {k: torch.as_tensor(v, device=self.device) for k, v in batch.items()}

    def validate_batch(self, batch):
        """(radiance (B,h,w,3), p_buffers {'diffuse','specular'} or None);
        accumulates ``l_test`` into ``m_losses['m_val']`` on the device."""
        radiance, p_buffers, l_test = self._val_step(self.to_device(batch))
        acc = self.m_losses.get("m_val", torch.zeros((), device=self.device))
        self.m_losses["m_val"] = acc + l_test
        return radiance, p_buffers
