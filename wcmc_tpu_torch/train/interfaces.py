"""Model interfaces: the contract between entry points and models.

Counterpart of ``wcmc_tpu/train/interfaces.py`` for KPCN (pixel space)
and SBMC / LBMC (sample space): ``preprocess``, ``to_train_mode``,
``train_batch``, ``validate_batch``, ``to_eval_mode`` and
``get_epoch_summary`` with the same batch-dict and loss-dict keys, the
PathNets (dual for KPCN, with fused sample moments; single for the
sample-space models), the detached ddof=1 variance feature, the
disentanglement modes and the fail-fast non-finite-loss check.  The
models hold their own parameters (``restore_interface`` loads
checkpoints into them); each model has its own optimizer
(``train/state.py``).  The machinery the interfaces share lives in
:class:`BaseInterface`.

The reference draws the manifold losses' pairings from a ``jax.random``
key per step; here they come from a ``torch.Generator`` seeded with the
config's seed, or are passed to ``train_batch`` (``draws``), so a test
can replay the reference's.  ``KPCNRefInterface`` (the oracle ablation:
the targets as extra inputs) and ``KPCNPreInterface`` (the two-phase
schedule: PathNet alone, then KPCN under the frozen PathNet) are the
reference's KPCN variants.

``to_mesh`` makes an interface data parallel over a
``parallel.mesh.Mesh``: each rank's ``train_batch`` and
``validate_batch`` take its shard of the global batch (cut on the host:
``parallel.mesh.shard_batch``, or the loaders' ``shard``), the gradients and losses are averaged over the data group, the manifold
losses' draws are for the global batch's shape and their cross-batch
term sees the gathered global batch; validation returns the global
radiance in batch order.

Layouts are channels-last: pixel ``(B,H,W,C)``, sample ``(B,S,H,W,C)``;
KPCN's manifold buffers of the train step are channel-major
``(B,S,C,H,W)``, the layout the losses take with ``cmajor``; the
sample-space models keep theirs channels-last.
"""

from __future__ import annotations

import copy
import os
from typing import Any, Callable, Dict, Optional

import torch

from wcmc_tpu_torch.models.pathnet import dual_pathnet_apply
from wcmc_tpu_torch.utils.utils import crop_like

Batch = Dict[str, torch.Tensor]

DISENTANGLE_MODES = ("m11r11", "m10r01", "m11r01", "m10r11")


def crop_hw(x, h_t: int, w_t: int):
    """Center-crop the LAST TWO (spatial) dims — the channel-major
    counterpart of ``crop_like``."""
    dh = (x.shape[-2] - h_t) // 2
    dw = (x.shape[-1] - w_t) // 2
    return x[..., dh:dh + h_t, dw:dw + w_t]


def p_buffer_variance(p_buffer):
    """Detached per-pixel embedding variance / spp, (B,S,H,W,C) ->
    (B,H,W,1): the unbiased (ddof=1) sample variance, averaged over
    channels.  The golden definition the interface's moment-based
    variance feature is held to."""
    s = p_buffer.shape[1]
    v = p_buffer.var(dim=1, unbiased=True).mean(dim=-1, keepdim=True) / s
    return v.detach()


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


class BaseInterface:
    """What every interface shares: the models and their optimizers, the
    step count, the accumulated losses, the manifold-loss generator, the
    train step around ``_train_loss`` and the validation step around
    ``_val_step``."""

    REQUIRED_KEYS: tuple = ()

    def __init__(self, models: Dict[str, torch.nn.Module],
                 loss_funcs: Dict[str, Callable], device, args=None,
                 optims: Optional[Dict[str, Any]] = None,
                 use_llpm_buf: bool = False, manif_learn: bool = False,
                 w_manif: float = 0.1, seed: int = 0, finite_check_every: int = 100):
        if "dncnn" not in models:
            raise ValueError(f"{type(self).__name__} needs a 'dncnn' model")
        if manif_learn and not use_llpm_buf:
            raise ValueError("manif_learn needs use_llpm_buf")
        if manif_learn and "l_manif" not in loss_funcs:
            raise ValueError("manif_learn needs an 'l_manif' loss")
        if "l_test" not in loss_funcs:
            raise ValueError(f"{type(self).__name__} needs an 'l_test' loss")
        self.models = models
        self.optims = optims or {}
        self.loss_funcs = loss_funcs
        self.device = torch.device(device)
        self.args = args
        self.use_llpm_buf = use_llpm_buf
        self.manif_learn = manif_learn
        self.w_manif = w_manif
        self.finite_check_every = finite_check_every
        self.iters = 0
        self.best_err = 1e10
        self.m_losses: Dict[str, torch.Tensor] = {}
        # optional debug: dump the p-buffer as PNG every N iters
        self.pbuf_dump_dir: Optional[str] = None
        self.pbuf_dump_every: int = 1000
        self.generator = torch.Generator().manual_seed(seed)
        self.mesh = None

    def preprocess(self, batch: Batch = None):
        """Check the batch's keys and count the step."""
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

    def to_train_mode(self):
        for name, m in self.models.items():
            if "optim_" + name not in self.optims:
                raise ValueError(f"`optim_{name}`: an optimization algorithm is not defined.")
            m.train()

    def train_batch(self, batch, grad_hook_mode: bool = False, draws=None):
        """One train step: forward, losses, backward and the optimizer
        step of each model the step trains.  Returns the loss dict (0-dim
        tensors on the device).  ``grad_hook_mode`` runs forward and
        backward and leaves the gradients in ``.grad`` without updating.
        ``draws`` replaces the step's manifold-loss draws (see
        ``draw_pairings``)."""
        if not grad_hook_mode:
            self._maybe_dump_pbuffer(batch)
        loss_dict = self._grad_step(batch, draws)
        if grad_hook_mode:
            return loss_dict
        for name in self._trained_models():
            self.optims["optim_" + name].step()
        self._logging(loss_dict)
        return loss_dict

    def _grad_step(self, batch, draws=None):
        """Forward and backward: the gradients in ``.grad``; returns the
        loss dict.  ``to_mesh`` wraps it (``parallel.mesh``)."""
        batch = self.to_device(batch)
        for opt in self.optims.values():
            opt.zero_grad()
        loss, loss_dict = self._train_loss(batch, draws)
        loss.backward()
        return loss_dict

    def _trained_models(self):
        """The models whose optimizers a step runs."""
        return list(self.models)

    def _global_shape(self, shape):
        """A per-rank shape with the global batch's leading size (the
        manifold draws are for the global batch)."""
        if self.mesh is None:
            return tuple(shape)
        return (shape[0] * self.mesh.n_data,) + tuple(shape[1:])

    def _data_group(self):
        """The data group the manifold loss gathers its cross-batch pairs
        over (None off a mesh)."""
        return None if self.mesh is None else self.mesh.data_group

    def _maybe_dump_pbuffer(self, batch):
        """With ``pbuf_dump_dir`` set and the path buffer on, write the
        first example's p-buffer (each branch's, sample mean of its first
        three channels, clipped to [0, 1]) as
        ``pbuf_<name>_<iters>.png`` at iterations 1, 1 + every, ..."""
        if self.pbuf_dump_dir is None or not self.use_llpm_buf:
            return
        if self.iters % self.pbuf_dump_every != 1:
            return
        from wcmc_tpu_torch.utils.img_utils import write_img

        os.makedirs(self.pbuf_dump_dir, exist_ok=True)
        _, p_buffers, _ = self._val_step(self.to_device(batch))
        if p_buffers is None:
            return
        if not isinstance(p_buffers, dict):
            p_buffers = {"p": p_buffers}
        for name, pb in p_buffers.items():
            img = pb[0, :, :, :, :3].float().mean(dim=0).clamp(0.0, 1.0)
            write_img(os.path.join(self.pbuf_dump_dir, f"pbuf_{name}_{self.iters}.png"),
                      img.cpu().numpy())

    def _logging(self, loss_dict):
        for key, val in loss_dict.items():
            acc = self.m_losses.get("m_" + key, torch.zeros((), device=self.device))
            self.m_losses["m_" + key] = acc + val
        if self.iters <= 1 or self.iters % self.finite_check_every == 0:
            for key, val in loss_dict.items():
                if not bool(torch.isfinite(val).all()):
                    raise RuntimeError(f"{key}: Non-finite loss at train time.")

    def get_epoch_summary(self, mode: str, norm: int) -> float:
        """Train: print and reset the accumulated losses, return -1.
        Otherwise the mean validation loss.  Both divide by ``norm * 2``,
        the reference's two-branch accounting."""
        if mode == "train":
            parts = []
            for key in list(self.m_losses):
                if key == "m_val":
                    continue
                val = float(self.m_losses[key]) / (norm * 2) * 1000
                parts.append(f"{key}: {val:.3f}E-3")
                self.m_losses[key] = torch.zeros((), device=self.device)
            print("[][][] " + "\t".join(parts))
            return -1.0
        return float(self.m_losses["m_val"]) / (norm * 2)

    def state_dicts(self):
        """{model name: (module, optimizer)}: what a checkpoint holds."""
        return {name: (m, self.optims.get("optim_" + name)) for name, m in self.models.items()}

    def to_mesh(self, mesh):
        """Data-parallel training and validation over ``mesh`` (a
        ``parallel.mesh.Mesh``; every rank calls this): rank 0's
        parameters and optimizer state broadcast to every rank, then each
        step on this rank's shard of the global batch (the caller's to
        cut) with the gradients and losses averaged over the data group,
        and validation gathering the global radiance.  Returns the
        interface."""
        from wcmc_tpu_torch.parallel.mesh import (
            Mesh, data_parallel_step, data_parallel_val, replicate,
        )

        if not isinstance(mesh, Mesh):
            raise TypeError(f"to_mesh takes a parallel.mesh.Mesh, not {type(mesh).__name__}")
        if self.mesh is not None:
            raise RuntimeError("the interface is on a mesh already")
        for m in self.models.values():
            if next(m.parameters()).device != mesh.device:
                raise ValueError(f"the models are on {next(m.parameters()).device}, the mesh's "
                                 f"rank on {mesh.device}")
        self.mesh = mesh
        replicate(self.models, self.optims, mesh)
        self._grad_step = data_parallel_step(self._grad_step, self.models, mesh)
        self._val_call = data_parallel_val(self._val_call, mesh)
        return self

    def to_device(self, batch) -> Batch:
        """Numpy arrays (bfloat16 ones too) or tensors -> tensors on this
        interface's device."""
        from wcmc_tpu_torch.data.prefetch import host_tensor

        return {k: host_tensor(v).to(self.device) for k, v in batch.items()}

    def _val_model(self, name: str = "dncnn"):
        """The model ``name`` as a primal-only (validation / inference)
        step runs it.  A model with a ``fused`` switch (KPCN) runs fused,
        its convolution chains through K6 (``ops/conv5.py``), when
        ``WCMC_FUSED_INFERENCE=1`` is set: a shallow copy with the switch
        on, sharing the parameters and sub-modules (no copy of the
        weights).  Every other model, and every model without the
        variable, is returned as it is.  The reference reads the variable
        once, when it compiles its validation step; the port has no
        compiled step, so the variable is read at every call.  Default
        off; training never comes here."""
        m = self.models[name]
        if hasattr(m, "fused") and os.environ.get("WCMC_FUSED_INFERENCE", "0") == "1":
            m = copy.copy(m)
            m.fused = True
        return m

    def validate_batch(self, batch):
        """(radiance, p-buffers or None) of ``_val_step``; accumulates
        ``l_test`` into ``m_losses['m_val']`` on the device."""
        radiance, p_buffers, l_test = self._val_call(batch)
        acc = self.m_losses.get("m_val", torch.zeros((), device=self.device))
        self.m_losses["m_val"] = acc + l_test
        return radiance, p_buffers

    def _val_call(self, batch):
        """``_val_step`` of a batch on this interface's device;
        ``to_mesh`` wraps it."""
        return self._val_step(self.to_device(batch))


class KPCNInterface(BaseInterface):
    """Diffuse/specular KPCN with the optional dual PathNet and the
    optional path-manifold loss."""

    REQUIRED_KEYS = (
        "target_total", "target_diffuse", "target_specular",
        "kpcn_diffuse_in", "kpcn_specular_in",
        "kpcn_diffuse_buffer", "kpcn_specular_buffer", "kpcn_albedo",
    )

    def __init__(self, models: Dict[str, torch.nn.Module],
                 loss_funcs: Dict[str, Callable], device, args=None,
                 optims: Optional[Dict[str, Any]] = None,
                 use_llpm_buf: bool = False, manif_learn: bool = False,
                 w_manif: float = 0.1, train_branches: bool = True,
                 disentanglement_option: str = "m11r11", seed: int = 0,
                 finite_check_every: int = 100):
        if use_llpm_buf and not {"backbone_diffuse", "backbone_specular"} <= set(models):
            raise ValueError("use_llpm_buf needs backbone_diffuse/backbone_specular")
        if disentanglement_option not in DISENTANGLE_MODES:
            raise ValueError(f"unknown disentangle mode {disentanglement_option!r}")
        super().__init__(models, loss_funcs, device, args, optims, use_llpm_buf, manif_learn,
                         w_manif, seed, finite_check_every)
        self.train_branches = train_branches
        self.disentanglement_option = disentanglement_option

    def __str__(self):
        return "KPCNInterface"

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
        """(B,H,W,C) per-channel sample variance -> the detached
        (B,H,W,1) variance/spp input feature: no gradient flows back
        through the sum of squares, as in the reference."""
        return (var_slice.mean(dim=-1, keepdim=True) / s).detach()

    def _forward_with_paths(self, batch, for_training=True):
        """PathNet forward + disentangle + input concat.  Returns
        (augmented batch, p-buffers {'diffuse','specular'}): for
        training the manifold halves in (B,S,C,H,W), else the
        reconstruction halves in (B,S,H,W,C), the validation output."""
        p_d, p_s, mean_d, mean_s, var_d, var_s = (
            self._dual_pathnet_with_moments(batch, cmajor=for_training))
        s = p_d.shape[1]
        opt = self.disentanglement_option
        if for_training:
            buffers = {"diffuse": split_disentangle(p_d, opt, axis=2)[0],
                       "specular": split_disentangle(p_s, opt, axis=2)[0]}
        else:
            buffers = {"diffuse": split_disentangle(p_d, opt)[1],
                       "specular": split_disentangle(p_s, opt)[1]}
        new_batch = dict(batch)
        for name, mean, var in (("diffuse", mean_d, var_d), ("specular", mean_s, var_s)):
            _, mean_recon = split_disentangle(mean, opt)
            _, var_recon = split_disentangle(var, opt)
            new_batch[f"kpcn_{name}_in"] = torch.cat(
                [batch[f"kpcn_{name}_in"], mean_recon,
                 self._variance_feature(var_recon, s)], dim=-1)
        return new_batch, buffers

    def draw_pairings(self, p_shape):
        """One train step's manifold-loss draws for p-buffers of
        ``p_shape`` (B,S,C,H,W), from this interface's generator:
        {'diffuse': ..., 'specular': ...}."""
        l_manif = self.loss_funcs["l_manif"]
        return {name: l_manif.draw(self.generator, p_shape, cmajor=True)
                for name in ("diffuse", "specular")}

    def _train_loss(self, batch, draws=None):
        """(loss to differentiate, loss dict of detached scalars)."""
        lf = self.loss_funcs
        loss_dict = {}
        net_batch, out_manif = batch, None
        if self.use_llpm_buf:
            net_batch, out_manif = self._forward_with_paths(batch)
        out = self.models["dncnn"](net_batch)
        total, diffuse, specular = out["radiance"], out["diffuse"], out["specular"]
        tgt_total = crop_like(batch["target_total"], total)
        if self.train_branches:
            tgt_diffuse = crop_like(batch["target_diffuse"], diffuse)
            tgt_specular = crop_like(batch["target_specular"], specular)
            l_diffuse = lf["l_diffuse"](diffuse, tgt_diffuse)
            l_specular = lf["l_specular"](specular, tgt_specular)
            loss_dict["l_diffuse"] = l_diffuse.detach()
            loss_dict["l_specular"] = l_specular.detach()
            loss = l_diffuse + l_specular
            if self.manif_learn:
                h_t, w_t = diffuse.shape[1], diffuse.shape[2]
                p_d = crop_hw(out_manif["diffuse"], h_t, w_t)
                p_s = crop_hw(out_manif["specular"], h_t, w_t)
                if draws is None:
                    draws = self.draw_pairings(self._global_shape(p_d.shape))
                group = self._data_group()
                l_md = lf["l_manif"](p_d, tgt_diffuse, draws["diffuse"], cmajor=True, group=group)
                l_ms = lf["l_manif"](p_s, tgt_specular, draws["specular"], cmajor=True,
                                     group=group)
                loss = loss + self.w_manif * (l_md + l_ms)
                loss_dict["l_manif_diffuse"] = l_md.detach()
                loss_dict["l_manif_specular"] = l_ms.detach()
            with torch.no_grad():
                loss_dict["l_total"] = lf["l_recon"](total, tgt_total)
        else:  # post-training the joint system
            loss = lf["l_recon"](total, tgt_total)
            loss_dict["l_total"] = loss.detach()
        with torch.no_grad():
            loss_dict["rmse"] = lf["l_test"](total, tgt_total)
        return loss, loss_dict

    @torch.inference_mode()
    def _val_step(self, batch):
        """(radiance (B,h,w,3), p-buffers {'diffuse','specular'} or None,
        l_test)."""
        p_buffers = None
        net_batch = batch
        if self.use_llpm_buf:
            net_batch, p_buffers = self._forward_with_paths(batch, for_training=False)
        out = self._val_model("dncnn")(net_batch)
        tgt_total = crop_like(batch["target_total"], out["radiance"])
        return out["radiance"], p_buffers, self.loss_funcs["l_test"](out["radiance"], tgt_total)


class KPCNRefInterface(KPCNInterface):
    """The oracle ablation: the target diffuse and specular radiance
    concatenated onto KPCN's inputs (3 channels each, so the dncnn's
    ``n_in`` is 3 wider), in training and validation alike.  Neither the
    path buffer nor the manifold loss."""

    def __init__(self, models, loss_funcs, device, args=None, optims=None,
                 use_llpm_buf: bool = False, manif_learn: bool = False, w_manif: float = 0.1,
                 train_branches: bool = True, seed: int = 0, finite_check_every: int = 100):
        if use_llpm_buf or manif_learn:
            raise ValueError("KPCNRefInterface takes neither the path buffer nor the "
                             "manifold loss")
        super().__init__(models, loss_funcs, device, args, optims, False, False, w_manif,
                         train_branches, "m11r11", seed, finite_check_every)

    @staticmethod
    def _augment(batch):
        new_batch = dict(batch)
        for name in ("diffuse", "specular"):
            new_batch[f"kpcn_{name}_in"] = torch.cat(
                [batch[f"kpcn_{name}_in"], batch[f"target_{name}"]], dim=-1)
        return new_batch

    def _train_loss(self, batch, draws=None):
        return super()._train_loss(self._augment(batch), draws)

    @torch.inference_mode()
    def _val_step(self, batch):
        return super()._val_step(self._augment(batch))


class KPCNPreInterface(KPCNInterface):
    """The two-phase schedule, with the path buffer always on; the phase
    is ``manif_learn``'s:

    (a) ``manif_learn``: the dual PathNet alone (channel-major, as the
        KPCN step runs it), loss ``w_manif * (l_manif(p_d, target_diffuse)
        + l_manif(p_s, target_specular))``; only the two backbones update
        and the dncnn never runs;
    (b) otherwise: KPCN under the frozen PathNet, whose forward runs
        without autograd (so neither backward kernel of the PathNet runs),
        the branch losses (``l_recon`` without ``train_branches``); only
        the dncnn updates."""

    def __init__(self, models, loss_funcs, device, args=None, optims=None,
                 manif_learn: bool = False, w_manif: float = 0.1, train_branches: bool = True,
                 seed: int = 0, finite_check_every: int = 100):
        super().__init__(models, loss_funcs, device, args, optims, True, manif_learn, w_manif,
                         train_branches, "m11r11", seed, finite_check_every)

    def __str__(self):
        return "KPCNPreInterface"

    def _trained_models(self):
        if self.manif_learn:
            return ["backbone_diffuse", "backbone_specular"]
        return ["dncnn"]

    def _train_loss(self, batch, draws=None):
        lf = self.loss_funcs
        if self.manif_learn:
            p_d, p_s = self._dual_pathnet_with_moments(batch, cmajor=True)[:2]
            if draws is None:
                draws = self.draw_pairings(self._global_shape(p_d.shape))
            group = self._data_group()
            l_md = lf["l_manif"](p_d, batch["target_diffuse"], draws["diffuse"], cmajor=True,
                                 group=group)
            l_ms = lf["l_manif"](p_s, batch["target_specular"], draws["specular"], cmajor=True,
                                 group=group)
            loss = self.w_manif * (l_md + l_ms)
            return loss, {"l_manif_diffuse": l_md.detach(), "l_manif_specular": l_ms.detach()}
        with torch.no_grad():   # the frozen PathNet
            net_batch, _ = self._forward_with_paths(batch)
        out = self.models["dncnn"](net_batch)
        total, diffuse, specular = out["radiance"], out["diffuse"], out["specular"]
        tgt_total = crop_like(batch["target_total"], total)
        if not self.train_branches:
            loss = lf["l_recon"](total, tgt_total)
            return loss, {"l_total": loss.detach()}
        l_diffuse = lf["l_diffuse"](diffuse, crop_like(batch["target_diffuse"], diffuse))
        l_specular = lf["l_specular"](specular, crop_like(batch["target_specular"], specular))
        with torch.no_grad():
            l_total = lf["l_recon"](total, tgt_total)
        return l_diffuse + l_specular, {"l_diffuse": l_diffuse.detach(),
                                        "l_specular": l_specular.detach(), "l_total": l_total}


# ===========================================================================
# SBMC / LBMC (sample space)
# ===========================================================================

class SBMCInterface(BaseInterface):
    """Sample-space training and validation: the single PathNet's
    p-buffer (its reconstruction half) and its detached variance join
    'features' on the channel axis, per sample."""

    REQUIRED_KEYS = ("target_image", "radiance", "features")

    def __init__(self, models: Dict[str, torch.nn.Module],
                 loss_funcs: Dict[str, Callable], device, args=None,
                 optims: Optional[Dict[str, Any]] = None,
                 use_llpm_buf: bool = False, manif_learn: bool = False,
                 w_manif: float = 0.1, use_sbmc_buf: bool = True,
                 disentangle: str = "m11r11", seed: int = 0,
                 finite_check_every: int = 100):
        if use_llpm_buf and "backbone" not in models:
            raise ValueError("use_llpm_buf needs a 'backbone' PathNet")
        if "l_recon" not in loss_funcs:
            raise ValueError(f"{type(self).__name__} needs an 'l_recon' loss")
        if disentangle not in DISENTANGLE_MODES:
            raise ValueError(f"unknown disentangle mode {disentangle!r}")
        super().__init__(models, loss_funcs, device, args, optims, use_llpm_buf, manif_learn,
                         w_manif, seed, finite_check_every)
        self.use_sbmc_buf = use_sbmc_buf
        self.disentangle = disentangle

    def __str__(self):
        return "SBMCInterface"

    def _augment_features(self, batch, slice_recon_only=False):
        """PathNet forward + per-sample concat.  Returns (augmented batch,
        manifold p-buffer, reconstruction p-buffer), (B,S,H,W,C) f32."""
        p_buffer = self.models["backbone"](batch)
        if slice_recon_only:
            if self.disentangle in ("m10r01", "m11r01"):
                p_recon = p_buffer[..., :p_buffer.shape[-1] // 2]
            else:
                p_recon = p_buffer
            p_manif = p_recon
        else:
            p_manif, p_recon = split_disentangle(p_buffer, self.disentangle)
        p_var = p_buffer_variance(p_recon)[:, None].expand(p_recon.shape[:4] + (1,))
        new_batch = dict(batch)
        new_batch["features"] = torch.cat([batch["features"], p_recon, p_var], dim=-1)
        return new_batch, p_manif, p_recon

    def draw_pairings(self, p_shape):
        """One train step's manifold-loss draws for a p-buffer of
        ``p_shape`` (B,S,H,W,C), from this interface's generator."""
        return self.loss_funcs["l_manif"].draw(self.generator, p_shape)

    def _train_loss(self, batch, draws=None):
        """(loss to differentiate, loss dict of detached scalars)."""
        lf = self.loss_funcs
        loss_dict = {}
        net_batch, out_manif = batch, None
        if self.use_llpm_buf:
            net_batch, out_manif, _ = self._augment_features(batch)
        out = self.models["dncnn"](net_batch)
        tgt_total = crop_like(batch["target_image"], out)
        l_total = lf["l_recon"](out, tgt_total)
        if self.manif_learn:
            p_buffer = crop_like(out_manif, out)
            if draws is None:
                draws = self.draw_pairings(self._global_shape(p_buffer.shape))
            l_manif = lf["l_manif"](p_buffer, tgt_total, draws, group=self._data_group())
            loss_dict["l_manif"] = l_manif.detach()
            loss_dict["l_recon"] = l_total.detach()
            l_total = l_total + l_manif * self.w_manif
        loss_dict["l_total"] = l_total.detach()
        with torch.no_grad():
            loss_dict["rmse"] = lf["l_test"](out, tgt_total)
        return l_total, loss_dict

    @torch.inference_mode()
    def _val_step(self, batch):
        """(radiance (B,H,W,3), reconstruction p-buffer (B,S,H,W,C) or
        None, l_test)."""
        p_buffer = None
        net_batch = batch
        if self.use_llpm_buf:
            net_batch, p_buffer, _ = self._augment_features(batch, slice_recon_only=True)
        out = self.models["dncnn"](net_batch)
        tgt_total = crop_like(batch["target_image"], out)
        return out, p_buffer, self.loss_funcs["l_test"](out, tgt_total)


class LBMCInterface(SBMCInterface):
    """LBMC: the sample-space interface without the SBMC path buffer
    (SMAPE reconstruction loss and global-norm clip 250 come from the
    factory)."""

    def __init__(self, models, loss_funcs, device, args=None, optims=None,
                 use_llpm_buf: bool = False, manif_learn: bool = False, w_manif: float = 0.1,
                 disentangle: str = "m11r11", seed: int = 0, finite_check_every: int = 100):
        super().__init__(models, loss_funcs, device, args, optims, use_llpm_buf, manif_learn,
                         w_manif, False, disentangle, seed, finite_check_every)

    def __str__(self):
        return "LBMCInterface"
