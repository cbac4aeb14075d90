"""The port's LBMC and SBMC training entry points from disk, on the CPU
(the corpus and arguments of ``test_torch_entry.py``, with the path
buffer): ``train_lbmc`` for its third epoch (``--start_epoch 2`` with nothing
to resume), one step without validation (its StepLR halves the denoiser's
learning rate after it; the manifold loss on), its p-buffer PNG read back
by ``imageio``; ``train_sbmc`` (``--sbmc_ksize 5 --use_sbmc_buf``) for
one step."""

import os

import numpy as np
import pytest
import torch

from wcmc_tpu_torch import train_lbmc, train_sbmc
from wcmc_tpu_torch.data.dataset import offline_preprocess
from wcmc_tpu_torch.data.synthetic import build_synthetic_dataset
from wcmc_tpu_torch.train.checkpoint import load_checkpoint
from wcmc_tpu_torch.utils import img_utils


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores among its
    workers, and more threads a worker mostly spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    build_synthetic_dataset(root, n_train=1, n_val=1, n_test=0, size=160, spp=2, seed=4)
    for mode in ("train", "val"):
        offline_preprocess(root, mode=mode, spp=8, sbmc=True, device="cpu")
    return root


def _argv(corpus, save, name, *extra):
    return ["--single_gpu", "--batch_size", "4", "--patches_per_image", "1",
            "--data_dir", corpus, "--model_name", name, "--desc", "entry test",
            "--save", save, "--compute_dtype", "float32", "--use_llpm_buf",
            "--device", "cpu", *extra]


def test_train_lbmc_step_lr_and_png_dumps(corpus, tmp_path):
    iio = pytest.importorskip("imageio.v3")
    save = str(tmp_path / "w")
    # --start_epoch 2 with no checkpoint to resume: epoch 2 alone, from scratch
    argv = _argv(corpus, save, "LBMC_entry", "--start_epoch", "2", "--num_epoch", "3",
                 "--val_epoch", "4",
                 "--lr_dncnn", "2e-4", "--manif_learn", "--manif_loss", "FMSE", "--visual")
    ifaces, params = train_lbmc.main(train_lbmc.parse_args(argv))
    iface = ifaces[0]
    # StepLR(3, 0.5) after epoch 2: 2e-4 * 0.5
    assert iface.optims["optim_dncnn"].lr == pytest.approx(1e-4)
    assert iface.optims["optim_backbone"].lr == pytest.approx(1e-4)   # --lr_pnet's
    assert iface.optims["optim_dncnn"].warmup_steps == 500
    assert [(s["epoch"], s["steps"]) for s in params["epoch_stats"]] == [(2, 1)]
    png = os.path.join(save, "logs", "LBMC_entry", "pbuf", "pbuf_p_1.png")
    img = iio.imread(png)
    assert img.dtype == np.uint8 and img.shape == (128, 128, 3)
    np.testing.assert_array_equal(img_utils.read_png(png), img)
    ck = load_checkpoint(os.path.join(save, "latest_LBMC_entry.ckpt"))
    assert ck["start_epoch"] == 3
    # saved before the epoch-end scheduler ran, as the reference saves
    assert float(ck["optim_dncnn"][1].args[1]["learning_rate"]) == pytest.approx(2e-4)


def test_train_sbmc_one_step(corpus, tmp_path):
    save = str(tmp_path / "w")
    argv = _argv(corpus, save, "SBMC_entry", "--num_epoch", "1", "--val_epoch", "2",
                 "--sbmc_ksize", "5", "--use_sbmc_buf", "--lr_dncnn", "5e-4")
    ifaces, params = train_sbmc.main(train_sbmc.parse_args(argv))
    assert [s["steps"] for s in params["epoch_stats"]] == [1]
    ck = load_checkpoint(os.path.join(save, "latest_SBMC_entry.ckpt"))
    assert ck["model"] == "SBMCInterface" and ck["args"].sbmc_ksize == 5
    assert not os.path.isfile(os.path.join(save, "SBMC_entry.ckpt"))   # no validation ran
