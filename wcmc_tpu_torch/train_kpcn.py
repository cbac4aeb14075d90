"""KPCN training entry point of the port.

Same flags as the repository's root ``train_kpcn.py``, plus ``--device``
(the CUDA card unless it names another device):

    python -m wcmc_tpu_torch.train_kpcn --single_gpu --batch_size 8 --val_epoch 1 \\
        --data_dir <root> --model_name KPCN_manifold_FMSE --desc "..." \\
        --num_epoch 8 --manif_loss FMSE --lr_dncnn 1e-4 --lr_pnet 1e-4 \\
        --use_llpm_buf --manif_learn --w_manif 0.1 --train_branches

``<root>`` holds ``train`` and ``val`` splits with their caches
(``data.dataset.offline_preprocess``).  Checkpoints go to ``--save``:
``latest_<model_name>.ckpt`` every epoch and ``<model_name>.ckpt`` when
validation improves; ``--start_epoch N`` resumes from the latter.
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
    return entry.init_data(args, "kpcn", device, use_g_buf=True, use_sbmc_buf=False,
                           pnet_out_size=3)


def make_config(args) -> TrainConfig:
    return TrainConfig(
        base_model="kpcn",
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
        train_branches=args.train_branches,
        kpcn_ref=args.kpcn_ref,
        kpcn_pre=args.kpcn_pre,
        seed=args.seed,
        compute_dtype=args.compute_dtype,
        kpcn_ksize=args.kpcn_ksize,
    )


def init_model(dataset, args, device=None):
    """Interfaces (resumed from the checkpoint when ``--start_epoch`` is
    not 0) and the loop's params."""
    return entry.init_model(args, make_config(args), device)


def build_parser():
    parser = BasicArgumentParser()
    add_common_train_flags(parser)
    parser.add_argument("--lr_dncnn", type=float, default=1e-4,
                        help="learning rate of KPCN.")
    add_manifold_flags(parser)
    parser.add_argument("--train_branches", action="store_true",
                        help="train the diffuse and specular branches independently.")
    parser.add_argument("--kpcn_ref", action="store_true",
                        help="train KPCN-Ref model.")
    parser.add_argument("--kpcn_pre", action="store_true",
                        help="train KPCN-Pre model.")
    parser.add_argument("--kpcn_ksize", type=int, default=21,
                        help="prediction kernel width.")
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
