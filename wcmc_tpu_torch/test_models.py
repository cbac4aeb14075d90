"""Full-frame evaluation entry point of the port.

Counterpart of the repository's root ``test_models.py``: builds the
interface for the model family named in ``--model_name``, restores the
checkpoint ``<save>/<model_name>.ckpt`` when there is one (a file
written by either package), runs tiled full-frame inference over scenes
x spp and writes the 5 x 4 metric grid CSVs (+ optional figures).
Runs on the card unless ``--device`` names another device.

Usage:
    python -m wcmc_tpu_torch.test_models --model_name KPCN_manif \
        --save ./weights --data_dir <root> --spps 8 --use_llpm_buf \
        [--device cuda] [--save_figures]

The model family comes from the name: SBMC, LBMC or KPCN (checked in
that order, as the reference does).
"""

from __future__ import annotations

import argparse
import os

from wcmc_tpu_torch.evaluate import denoise
from wcmc_tpu_torch.train.checkpoint import load_checkpoint, restore_interface
from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces


def model_config(args, base: str) -> TrainConfig:
    """The model config of the ``base`` family ("kpcn", "sbmc" or "lbmc")
    from the CLI flags: the reference's ``train_kpcn.make_config`` /
    ``train_sbmc.make_config`` / ``train_lbmc.make_config``."""
    if base == "kpcn":
        extra = dict(train_branches=args.train_branches, kpcn_ref=args.kpcn_ref,
                     kpcn_pre=args.kpcn_pre, kpcn_ksize=args.kpcn_ksize)
    elif base == "sbmc":
        extra = dict(use_g_buf=args.use_g_buf, use_sbmc_buf=args.use_sbmc_buf,
                     sbmc_ksize=args.sbmc_ksize,
                     sbmc_splat=getattr(args, "sbmc_splat", "exp"),
                     warmup_steps=getattr(args, "warmup_steps", 0))
    else:
        extra = dict(warmup_steps=getattr(args, "warmup_steps", 0))
    return TrainConfig(
        base_model=base,
        model_name=args.model_name,
        batch_size=args.batch_size,
        lr_dncnn=args.lr_dncnn,
        lr_pnet=tuple(args.lr_pnet),
        pnet_out_size=tuple(args.pnet_out_size),
        w_manif=tuple(args.w_manif),
        use_llpm_buf=args.use_llpm_buf,
        manif_learn=args.manif_learn,
        manif_loss=args.manif_loss,
        local=args.local,
        manif_pairing=getattr(args, "manif_pairing", "roll"),
        disentangle=args.disentangle,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        **extra,
    )


def build_interface(args):
    """The interface of the family named in ``--model_name`` (SBMC, then
    LBMC, then KPCN, as the reference checks), with the checkpoint
    restored when there is one; returns (interface, base model)."""
    if "SBMC" in args.model_name:
        base = "sbmc"
    elif "LBMC" in args.model_name:
        base = "lbmc"
    elif "KPCN" in args.model_name:
        base = "kpcn"
    else:
        raise ValueError("model_name must contain KPCN, SBMC, or LBMC: "
                         f"{args.model_name!r}")
    iface = init_interfaces(model_config(args, base), args, device=args.device)[0]
    name = args.model_name
    p_model = os.path.join(args.save, name if name.endswith(".ckpt") else name + ".ckpt")
    if os.path.isfile(p_model):
        restore_interface(iface, load_checkpoint(p_model))
        print(f"Loaded checkpoint {p_model}")
    else:
        print(f"WARNING: no checkpoint at {p_model}; evaluating random init")
    return iface, base


def main(args):
    """Build the interface, denoise, print one line per frame.
    Returns (results, interface)."""
    iface, base = build_interface(args)
    results = denoise(
        iface,
        os.path.join(args.data_dir, "test", "input"),
        base,
        scenes=args.scenes,
        spps=tuple(args.spps),
        output_dir=args.output_dir,
        use_g_buf=args.use_g_buf,
        use_sbmc_buf=args.use_sbmc_buf,
        use_llpm_buf=args.use_llpm_buf,
        pnet_out_size=args.pnet_out_size[0],
        save_figures=args.save_figures,
        rhf=args.rhf,
        feat_imp=args.feat_imp,
    )
    for (scene, spp), v in sorted(results.items()):
        print(
            f"{scene} @ {spp}spp: RelMSE={v['output']['linear_RelMSE']:.5f} "
            f"(input {v['input']['linear_RelMSE']:.5f}), "
            f"DSSIM={v['output']['gamma22_DSSIM']:.5f}, "
            f"{v['output']['inference_sec']:.2f}s"
        )
    return results, iface


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--model_name", type=str, required=True)
    parser.add_argument("--save", type=str, default="./weights")
    parser.add_argument("--data_dir", type=str, required=True)
    parser.add_argument("--output_dir", type=str, default="./eval_out")
    parser.add_argument("--scenes", type=str, nargs="*", default=None)
    parser.add_argument("--spps", type=int, nargs="+", default=[8])
    parser.add_argument("--save_figures", action="store_true")
    parser.add_argument("--rhf", action="store_true",
                        help="export the p-buffer for RHF visualization.")
    parser.add_argument("--feat_imp", action="store_true",
                        help="feature-importance permutation test: shuffle "
                        "path descriptors across positions before inference.")
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: the CUDA card; fails "
                        "without one)")
    # model-config flags (must match training)
    parser.add_argument("--batch_size", type=int, default=8)
    parser.add_argument("--lr_dncnn", type=float, default=1e-4)
    parser.add_argument("--lr_pnet", type=float, nargs="+", default=[1e-4])
    parser.add_argument("--pnet_out_size", type=int, nargs="+", default=[3])
    parser.add_argument("--w_manif", type=float, nargs="+", default=[0.1])
    parser.add_argument("--use_g_buf", action="store_false")
    parser.add_argument("--use_sbmc_buf", action="store_true")
    parser.add_argument("--use_llpm_buf", action="store_true")
    parser.add_argument("--manif_learn", action="store_true")
    parser.add_argument("--manif_loss", type=str, default=None)
    parser.add_argument("--local", action="store_true")
    parser.add_argument("--disentangle", type=str, default="m11r11")
    parser.add_argument("--train_branches", action="store_true")
    parser.add_argument("--kpcn_ref", action="store_true")
    parser.add_argument("--kpcn_pre", action="store_true")
    parser.add_argument("--model_name_contains", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--compute_dtype", type=str, default="bfloat16")
    parser.add_argument("--kpcn_ksize", type=int, default=21,
                        help="prediction kernel width used at training.")
    parser.add_argument("--sbmc_ksize", type=int, default=21,
                        help="splat kernel width used at training.")
    return parser.parse_args(argv)


if __name__ == "__main__":
    main(parse_args())
