"""LBMC training entry point of the port.

Same flags as the repository's root ``train_lbmc.py``, plus ``--device``
(the CUDA card unless it names another device); StepLR(step 3, gamma
0.5) on the denoiser's learning rate at the end of each epoch:

    python -m wcmc_tpu_torch.train_lbmc --single_gpu --batch_size 8 --val_epoch 1 \\
        --data_dir <root> --model_name LBMC_vanilla --desc "LBMC_vanilla" \\
        --num_epoch 6

``--warmup_steps`` defaults to 500 here (``TrainConfig`` keeps 0).
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
from wcmc_tpu_torch.train.loop import step_lr

BS_VAL = entry.BS_VAL


def init_data(args, device=None):
    return entry.init_data(args, "lbmc", device, use_g_buf=True, use_sbmc_buf=False,
                           pnet_out_size=0)


def make_config(args) -> TrainConfig:
    return TrainConfig(
        base_model="lbmc",
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
        manif_pairing=args.manif_pairing,
        disentangle=args.disentangle,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        warmup_steps=args.warmup_steps,
    )


def _params(args):
    # the denoiser's epoch schedule: StepLR(3, 0.5)
    return {"sched_dncnn": step_lr(args.lr_dncnn, step_size=3, gamma=0.5)}


def init_model(dataset, args, device=None):
    """Interfaces (resumed from the checkpoint when ``--start_epoch`` is
    not 0) and the loop's params, with the denoiser's StepLR."""
    return entry.init_model(args, make_config(args), device, _params(args))


def build_parser():
    parser = BasicArgumentParser()
    add_common_train_flags(parser)
    parser.add_argument("--use_g_buf", action="store_false")
    parser.add_argument("--lr_dncnn", type=float, default=1e-4,
                        help="learning rate of the LBMC denoiser.")
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
