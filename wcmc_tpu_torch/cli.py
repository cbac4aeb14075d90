"""Shared CLI argument surface of the port's entry points.

Counterpart of ``wcmc_tpu/cli.py``: the same flags, defaults, types and
choices as ``BasicArgumentParser``, ``add_manifold_flags`` and
``add_common_train_flags``, plus one flag of the port, ``--device``: the
torch device the entry point runs on (the CUDA card unless it names
another; without a card and without ``--device cpu`` the entry point
raises, see ``utils.utils.resolve_device``).  ``--n_devices`` above 1
trains data parallel over that many ranks, which the entry point spawns
itself (``train/entry.py``): one card each over NCCL, or gloo ranks on
the CPU with ``--device cpu``.
"""

from __future__ import annotations

import argparse


class BasicArgumentParser(argparse.ArgumentParser):
    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.add_argument("--sbmc", action="store_true",
                          help="train the Sample-based Kernel Splatting Network.")
        self.add_argument("--p_buf", action="store_true",
                          help="use the multi-bounce path buffers for denoising.")
        self.add_argument("--model_name", type=str, default="tSUNet",
                          help="name of the model.")
        self.add_argument("--data_dir", type=str, default="./data",
                          help="directory of dataset")
        self.add_argument("--visual", action="store_true",
                          help="write metric/plot files instead of terminal-only logs.")
        self.add_argument("-b", "--batch_size", type=int, default=64,
                          help="batch size.")
        self.add_argument("-e", "--num_epoch", type=int, default=100,
                          help="number of epochs.")
        self.add_argument("-v", "--val_epoch", type=int, default=1,
                          help="validate the model every val_epoch epoch.")
        # accepted for flag parity and read nowhere, as in the reference
        self.add_argument("--vis_iter", type=int, default=4,
                          help="visualize the training dataset every vis_iter iteration.")
        self.add_argument("--start_epoch", type=int, default=0,
                          help="from which epoch to start.")
        self.add_argument("--num_samples", type=int, default=8,
                          help="number of samples to be displayed.")
        self.add_argument("--save", type=str, default="./weights",
                          help="directory to save the model.")
        self.add_argument("--overfit", action="store_true",
                          help="launch overfitting test.")
        self.add_argument("--seed", type=int, default=0)
        self.add_argument("--n_devices", type=int, default=0,
                          help="data-parallel devices (0 = all available).")
        self.add_argument("--profile_dir", type=str, default=None,
                          help="write a torch.profiler trace of the first epoch here.")
        self.add_argument("--synthetic_data", action="store_true",
                          help="train on generated synthetic scenes (no data_dir needed).")
        self.add_argument("--compute_dtype", type=str, default="bfloat16",
                          choices=["bfloat16", "float32"],
                          help="activation compute dtype (params stay f32).")
        self.add_argument("--patches_per_image", type=int, default=None,
                          help="override patches sampled per image "
                          "(default: reference formula (256//bs)*bs).")
        self.add_argument("--serve_bf16", action="store_true",
                          help="serve the LLPM 'paths' tensor as bfloat16 "
                          "from the host loader (halves the dominant "
                          "host-copy + transfer bytes; PathNet computes "
                          "in bf16 either way).")
        self.add_argument("--device", type=str, default=None,
                          help="torch device (default: the CUDA card; fails "
                          "without one)")


def add_manifold_flags(parser):
    parser.add_argument("--lr_pnet", type=float, nargs="+", default=[1e-4],
                        help="learning rate of PathNet.")
    parser.add_argument("--pnet_out_size", type=int, nargs="+", default=[3],
                        help="# of channels of outputs of PathNet.")
    parser.add_argument("--manif_loss", type=str, required=False,
                        help="`FMSE` or `GRS`")
    parser.add_argument("--use_llpm_buf", action="store_true",
                        help="use the llpm-specific buffer.")
    parser.add_argument("--manif_learn", action="store_true",
                        help="use the manifold learning loss.")
    parser.add_argument("--w_manif", type=float, nargs="+", default=[0.1],
                        help="ratio of the manifold loss to the recon loss.")
    parser.add_argument("--disentangle", type=str, default="m11r11",
                        help="`m11r11`, `m10r01`, `m10r11`, or `m11r01`")
    parser.add_argument("--local", action="store_true")
    parser.add_argument("--manif_pairing", type=str, default="roll",
                        choices=["roll", "permutation"],
                        help="FMSE/GRS pair sampling: 'permutation' draws a "
                             "permutation; 'roll' draws one shift (see losses.py).")


def add_common_train_flags(parser):
    parser.add_argument("--desc", type=str, required=True,
                        help="short description of the current experiment.")
    parser.add_argument("--single_gpu", action="store_true",
                        help="compat flag: single-device training.")
    parser.add_argument("--device_id", type=int, default=0)
    parser.add_argument("--lr_ckpt", action="store_true",
                        help="use the checkpoint learning rate on resume.")
    parser.add_argument("--best_err", type=float, required=False)
    parser.add_argument("--not_save", action="store_true",
                        help="do not save checkpoint (debugging purpose).")


def validate_manifold_flags(args):
    if args.manif_learn and not args.use_llpm_buf:
        raise RuntimeError(
            "The manifold learning module requires a llpm-specific buffer.")
    if args.manif_learn and not args.manif_loss:
        raise RuntimeError("The manifold learning module requires a manifold loss.")
    if not args.manif_learn and args.manif_loss:
        raise RuntimeError(
            "A manifold loss is not necessary when the manifold learning "
            "module is opted out.")
    if args.manif_learn and args.manif_loss not in ("GRS", "FMSE"):
        raise RuntimeError("Argument `manif_loss` should be either `FMSE` or `GRS`")
    if args.disentangle not in ("m11r11", "m10r01", "m10r11", "m11r01"):
        raise RuntimeError(
            "Argument `disentangle` should be either `m11r11`, `m10r01`, "
            "`m10r11`, or `m11r01`")
    for s in args.pnet_out_size:
        if args.disentangle != "m11r11" and s % 2 != 0:
            raise RuntimeError("Argument `pnet_out_size` should be a list of even numbers")
