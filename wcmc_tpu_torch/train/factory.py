"""Model and interface assembly shared by entry points and tests.

Counterpart of ``wcmc_tpu/train/factory.py``: the config dataclass and
the KPCN branch of ``init_interfaces``, which builds the models with
flax-style initial parameters from ``cfg.seed``, one Adam with value
clip per model, and the losses.  SBMC and LBMC come with their ports.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from wcmc_tpu_torch import losses
from wcmc_tpu_torch.data import schema
from wcmc_tpu_torch.models import KPCN, PathNet
from wcmc_tpu_torch.train import interfaces as itf
from wcmc_tpu_torch.train.state import adam_with_clip
from wcmc_tpu_torch.utils.utils import resolve_device


@dataclass
class TrainConfig:
    """The reference's model-assembly flags for KPCN (same names and
    defaults as in ``wcmc_tpu.train.factory.TrainConfig``; the SBMC and
    LBMC flags come with their ports)."""

    base_model: str = "kpcn"              # kpcn | sbmc | lbmc
    model_name: str = "model"
    batch_size: int = 8
    spp: int = 8
    patch_size: int = schema.PATCH_SIZE

    lr_dncnn: float = 1e-4
    lr_pnet: Sequence[float] = (1e-4,)
    pnet_out_size: Sequence[int] = (3,)
    w_manif: Sequence[float] = (0.1,)

    use_llpm_buf: bool = False
    manif_learn: bool = False
    manif_loss: Optional[str] = None       # FMSE | GRS
    local: bool = False                    # FMSE locality flag
    manif_pairing: str = "roll"            # roll | permutation
    disentangle: str = "m11r11"

    train_branches: bool = True            # KPCN
    kpcn_ref: bool = False
    kpcn_pre: bool = False

    seed: int = 0
    kpcn_ksize: int = 21
    finite_check_every: int = 100
    compute_dtype: str = "bfloat16"   # activations; params and optimizer stay f32
    warmup_steps: int = 0             # linear update warmup (train/state.py)

    @property
    def model_dtype(self):
        return {"bfloat16": torch.bfloat16, "float32": None}[self.compute_dtype]

    def validate(self):
        """Cross-flag rules of the reference CLI."""
        if self.manif_learn and not self.use_llpm_buf:
            raise ValueError(
                "The manifold learning module requires a llpm-specific buffer.")
        if self.manif_learn and not self.manif_loss:
            raise ValueError("The manifold learning module requires a manifold loss.")
        if not self.manif_learn and self.manif_loss:
            raise ValueError(
                "A manifold loss is not necessary when the manifold learning "
                "module is opted out.")
        if self.manif_learn and self.manif_loss not in ("FMSE", "GRS"):
            raise ValueError("manif_loss should be either FMSE or GRS")
        if self.disentangle not in ("m11r11", "m10r01", "m10r11", "m11r01"):
            raise ValueError("unknown disentangle mode")
        for s in self.pnet_out_size:
            if self.disentangle != "m11r11" and s % 2 != 0:
                raise ValueError("pnet_out_size must be even when disentangling")
        return self


def init_interfaces(cfg: TrainConfig, args=None, device=None):
    """Build one interface per hyperparameter-grid combination, on
    ``device`` (the card unless given)."""
    cfg.validate()
    device = resolve_device(device)
    out = []
    grid = list(itertools.product(cfg.lr_pnet, cfg.pnet_out_size, cfg.w_manif))
    for trial, (lr_pnet, pnet_out, w_manif) in enumerate(grid):
        if cfg.base_model == "kpcn":
            iface = _build_kpcn(cfg, lr_pnet, pnet_out, w_manif, cfg.seed + trial,
                                args, device)
        elif cfg.base_model in ("sbmc", "lbmc"):
            raise NotImplementedError(f"{cfg.base_model} is not ported yet")
        else:
            raise ValueError(cfg.base_model)
        iface.grid_params = {
            "lr_pnet": lr_pnet, "pnet_out_size": pnet_out, "w_manif": w_manif,
        }
        out.append(iface)
    return out


def _build_kpcn(cfg, lr_pnet, pnet_out, w_manif, seed, args, device):
    if cfg.kpcn_ref or cfg.kpcn_pre:
        raise NotImplementedError("the KPCN ref/pre variants are not ported yet")
    channels = schema.ChannelConfig(
        "kpcn", use_llpm_buf=cfg.use_llpm_buf, pnet_out_size=pnet_out,
        disentangle=cfg.disentangle,
    )
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.model_dtype
    models = {"dncnn": KPCN(n_in=channels.dncnn_in_size, ksize=cfg.kpcn_ksize,
                            dtype=dt, generator=gen)}
    if cfg.use_llpm_buf:
        for name in ("backbone_diffuse", "backbone_specular"):
            models[name] = PathNet(ic=channels.pnet_in_size, outc=pnet_out,
                                   dtype=dt, generator=gen)
    models = {k: m.to(device).eval() for k, m in models.items()}
    optims = {
        "optim_" + name: adam_with_clip(
            m.parameters(), cfg.lr_dncnn if name == "dncnn" else lr_pnet, clip_value=1.0)
        for name, m in models.items()
    }
    loss_funcs = {
        "l_diffuse": losses.l1,
        "l_specular": losses.l1,
        "l_recon": losses.l1,
        "l_test": losses.relative_mse,
    }
    if cfg.manif_learn:
        loss_funcs["l_manif"] = losses.make_manifold_loss(
            cfg.manif_loss, non_local=not cfg.local, pairing=cfg.manif_pairing)
    return itf.KPCNInterface(
        models, loss_funcs, device, args=args, optims=optims,
        use_llpm_buf=cfg.use_llpm_buf, manif_learn=cfg.manif_learn, w_manif=w_manif,
        train_branches=cfg.train_branches, disentanglement_option=cfg.disentangle,
        seed=cfg.seed, finite_check_every=cfg.finite_check_every,
    )
