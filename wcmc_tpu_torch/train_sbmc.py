"""SBMC training entry point of the port.

Same flags as the repository's root ``train_sbmc.py``, plus ``--device``
(the CUDA card unless it names another device):

    python -m wcmc_tpu_torch.train_sbmc --single_gpu --batch_size 8 --val_epoch 1 \\
        --data_dir <root> --model_name SBMC_vanilla --desc "SBMC_vanilla" \\
        --num_epoch 6 --lr_dncnn 5e-4 --use_sbmc_buf

``--warmup_steps`` defaults to 500 here (``TrainConfig`` keeps 0).  The
SBMC path buffer (``--use_sbmc_buf``) needs the ``*_sbmc_p.npy`` caches
(``offline_preprocess(..., sbmc=True)``).
"""

from __future__ import annotations

from wcmc_tpu_torch.cli import (
    BasicArgumentParser,
    add_common_train_flags,
    add_manifold_flags,
    validate_manifold_flags,
)
from wcmc_tpu_torch.train import entry
from wcmc_tpu_torch.train.factory import TrainConfig

BS_VAL = entry.BS_VAL


def init_data(args, device=None):
    return entry.init_data(args, "sbmc", device, use_g_buf=args.use_g_buf,
                           use_sbmc_buf=args.use_sbmc_buf, pnet_out_size=0)


def make_config(args) -> TrainConfig:
    return TrainConfig(
        base_model="sbmc",
        model_name=args.model_name,
        batch_size=args.batch_size,
        lr_dncnn=args.lr_dncnn,
        lr_pnet=tuple(args.lr_pnet),
        pnet_out_size=tuple(args.pnet_out_size),
        w_manif=tuple(args.w_manif),
        use_g_buf=args.use_g_buf,
        use_sbmc_buf=args.use_sbmc_buf,
        use_llpm_buf=args.use_llpm_buf,
        manif_learn=args.manif_learn,
        manif_loss=args.manif_loss,
        local=args.local,
        manif_pairing=args.manif_pairing,
        disentangle=args.disentangle,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        sbmc_ksize=args.sbmc_ksize,
        sbmc_splat=args.sbmc_splat,
        warmup_steps=args.warmup_steps,
    )


def init_model(dataset, args, device=None):
    """Interfaces (resumed from the checkpoint when ``--start_epoch`` is
    not 0) and the loop's params."""
    return entry.init_model(args, make_config(args), device)


def build_parser():
    parser = BasicArgumentParser()
    add_common_train_flags(parser)
    parser.add_argument("--use_g_buf", action="store_false")
    parser.add_argument("--lr_dncnn", type=float, default=1e-4,
                        help="learning rate of the SBMC denoiser.")
    parser.add_argument("--use_sbmc_buf", action="store_true",
                        help="use the sbmc-specific buffer.")
    parser.add_argument("--sbmc_ksize", type=int, default=21,
                        help="splatting kernel width.")
    parser.add_argument("--sbmc_splat", type=str, default="exp",
                        choices=("exp", "softmax"),
                        help="splat-weight parameterization: 'exp' (per-pixel "
                             "stabilized, firefly rejection) or 'softmax' (the "
                             "per-sample-normalized ablation knob).")
    parser.add_argument("--warmup_steps", type=int, default=500,
                        help="linear update warmup (0 restores a cold start)")
    add_manifold_flags(parser)
    return parser


def parse_args(argv=None):
    args = build_parser().parse_args(argv)
    validate_manifold_flags(args)
    return args


def main(args):
    """Train; returns (interfaces, params)."""
    return entry.run(args, init_data, init_model)


if __name__ == "__main__":
    main(parse_args())
