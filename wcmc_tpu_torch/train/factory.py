"""Model and interface assembly shared by entry points and tests.

Counterpart of ``wcmc_tpu/train/factory.py``: the config dataclass and
``init_interfaces``, which builds the models with flax-style initial
parameters from ``cfg.seed``, one Adam per model (value clip 1.0 for
KPCN, global-norm clip 1000 for SBMC and 250 for LBMC) and the losses.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Sequence

import torch

from wcmc_tpu_torch import losses
from wcmc_tpu_torch.data import schema
from wcmc_tpu_torch.models import KPCN, LayerNet, Multisteps, PathNet
from wcmc_tpu_torch.train import interfaces as itf
from wcmc_tpu_torch.train.state import adam_with_clip
from wcmc_tpu_torch.utils.utils import resolve_device


@dataclass
class TrainConfig:
    """The reference's model-assembly flags (same names and defaults as
    in ``wcmc_tpu.train.factory.TrainConfig``)."""

    base_model: str = "kpcn"              # kpcn | sbmc | lbmc
    model_name: str = "model"
    batch_size: int = 8
    spp: int = 8
    patch_size: int = schema.PATCH_SIZE

    lr_dncnn: float = 1e-4
    lr_pnet: Sequence[float] = (1e-4,)
    pnet_out_size: Sequence[int] = (3,)
    w_manif: Sequence[float] = (0.1,)

    use_g_buf: bool = True                 # sample-space models
    use_sbmc_buf: bool = True
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
    sbmc_ksize: int = 21
    sbmc_splat: str = "exp"               # exp (log-domain weights) | softmax (ablation)
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
        elif cfg.base_model == "lbmc":
            iface = _build_lbmc(cfg, lr_pnet, pnet_out, w_manif, cfg.seed + trial,
                                args, device)
        elif cfg.base_model == "sbmc":
            iface = _build_sbmc(cfg, lr_pnet, pnet_out, w_manif, cfg.seed + trial,
                                args, device)
        else:
            raise ValueError(cfg.base_model)
        iface.grid_params = {
            "lr_pnet": lr_pnet, "pnet_out_size": pnet_out, "w_manif": w_manif,
        }
        out.append(iface)
    return out


def sweep_checkpoint_name(save_dir, model_name, interfaces, i):
    """Checkpoint file name of grid trial ``i``: the bare model name for
    a single-point grid, else the hyperparameter-encoded
    ``<name>_lp%f_pos%d_wgt%f`` form (``<name>_trial<i>`` for interfaces
    built by hand, which carry no grid point)."""
    import os

    if len(interfaces) == 1:
        return os.path.join(save_dir, model_name + ".ckpt")
    gp = getattr(interfaces[i], "grid_params", None)
    if gp is None:
        return os.path.join(save_dir, f"{model_name}_trial{i}.ckpt")
    return os.path.join(
        save_dir, "%s_lp%f_pos%d_wgt%f.ckpt"
        % (model_name, gp["lr_pnet"], gp["pnet_out_size"], gp["w_manif"]))


def _manif_loss_fn(cfg):
    return losses.make_manifold_loss(cfg.manif_loss, non_local=not cfg.local,
                                     pairing=cfg.manif_pairing)


def _build_kpcn(cfg, lr_pnet, pnet_out, w_manif, seed, args, device):
    channels = schema.ChannelConfig(
        "kpcn", use_llpm_buf=cfg.use_llpm_buf, pnet_out_size=pnet_out,
        disentangle=cfg.disentangle,
    )
    # the ref variant's inputs carry the 3 target channels too
    n_in = channels.dncnn_in_size + (3 if cfg.kpcn_ref else 0)
    gen = torch.Generator().manual_seed(seed)
    dt = cfg.model_dtype
    models = {"dncnn": KPCN(n_in=n_in, ksize=cfg.kpcn_ksize, dtype=dt, generator=gen)}
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
        loss_funcs["l_manif"] = _manif_loss_fn(cfg)
    kw = dict(seed=cfg.seed, finite_check_every=cfg.finite_check_every)
    if cfg.kpcn_ref:
        return itf.KPCNRefInterface(
            models, loss_funcs, device, args=args, optims=optims,
            use_llpm_buf=cfg.use_llpm_buf, manif_learn=cfg.manif_learn,
            train_branches=cfg.train_branches, **kw)
    if cfg.kpcn_pre:
        return itf.KPCNPreInterface(
            models, loss_funcs, device, args=args, optims=optims, manif_learn=cfg.manif_learn,
            w_manif=w_manif, train_branches=cfg.train_branches, **kw)
    return itf.KPCNInterface(
        models, loss_funcs, device, args=args, optims=optims,
        use_llpm_buf=cfg.use_llpm_buf, manif_learn=cfg.manif_learn, w_manif=w_manif,
        train_branches=cfg.train_branches, disentanglement_option=cfg.disentangle,
        seed=cfg.seed, finite_check_every=cfg.finite_check_every,
    )


def _sbmc_like_build(cfg, lr_pnet, pnet_out, seed, model_ctor, clip_norm, device):
    """The sample-space models ('dncnn' and, with ``use_llpm_buf``, the
    single PathNet 'backbone') on ``device``, and one Adam with
    global-norm clip per model."""
    channels = schema.ChannelConfig(
        cfg.base_model, use_g_buf=cfg.use_g_buf, use_sbmc_buf=cfg.use_sbmc_buf,
        use_llpm_buf=cfg.use_llpm_buf, pnet_out_size=pnet_out, disentangle=cfg.disentangle,
    )
    gen = torch.Generator().manual_seed(seed)
    models = {"dncnn": model_ctor(channels.dncnn_in_size, gen)}
    if cfg.use_llpm_buf:
        models["backbone"] = PathNet(ic=channels.pnet_in_size, outc=pnet_out,
                                     dtype=cfg.model_dtype, generator=gen)
    models = {k: m.to(device).eval() for k, m in models.items()}
    optims = {
        "optim_" + name: adam_with_clip(
            m.parameters(), cfg.lr_dncnn if name == "dncnn" else lr_pnet,
            clip_norm=clip_norm, warmup_steps=cfg.warmup_steps)
        for name, m in models.items()
    }
    return models, optims


def _build_sbmc(cfg, lr_pnet, pnet_out, w_manif, seed, args, device):
    models, optims = _sbmc_like_build(
        cfg, lr_pnet, pnet_out, seed,
        lambda n, gen: Multisteps(n_in=n, ksize=cfg.sbmc_ksize, dtype=cfg.model_dtype,
                                  splat_weighting=cfg.sbmc_splat, generator=gen),
        clip_norm=1000.0, device=device)
    loss_funcs = {"l_recon": losses.tonemapped_relative_mse, "l_test": losses.relative_mse}
    if cfg.manif_learn:
        loss_funcs["l_manif"] = _manif_loss_fn(cfg)
    return itf.SBMCInterface(
        models, loss_funcs, device, args=args, optims=optims,
        use_llpm_buf=cfg.use_llpm_buf, manif_learn=cfg.manif_learn, w_manif=w_manif,
        use_sbmc_buf=cfg.use_sbmc_buf, disentangle=cfg.disentangle, seed=cfg.seed,
        finite_check_every=cfg.finite_check_every,
    )


def _clamped_smape(im, ref):
    """LBMC reconstruction loss: SMAPE on [0, 100]-clamped radiance."""
    return losses.smape(im.clamp(0.0, 100.0), ref.clamp(0.0, 100.0))


def _build_lbmc(cfg, lr_pnet, pnet_out, w_manif, seed, args, device):
    models, optims = _sbmc_like_build(
        cfg, lr_pnet, pnet_out, seed,
        lambda n, gen: LayerNet(n_in=n, dtype=cfg.model_dtype, generator=gen),
        clip_norm=250.0, device=device)
    loss_funcs = {"l_recon": _clamped_smape, "l_test": losses.relative_mse}
    if cfg.manif_learn:
        loss_funcs["l_manif"] = _manif_loss_fn(cfg)
    return itf.LBMCInterface(
        models, loss_funcs, device, args=args, optims=optims,
        use_llpm_buf=cfg.use_llpm_buf, manif_learn=cfg.manif_learn, w_manif=w_manif,
        disentangle=cfg.disentangle, seed=cfg.seed, finite_check_every=cfg.finite_check_every,
    )
