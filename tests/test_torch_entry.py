"""The port's training entry points from disk, on the CPU.

* Flags: each of ``python -m wcmc_tpu_torch.train_kpcn`` / ``.train_lbmc``
  / ``.train_sbmc`` has every option of the repository's root script (its
  parser captured by running the script with ``parse_args`` stopped), with
  the same option strings, default, type, ``required``, ``nargs``,
  choices and action, plus ``--device``.
* Runs on a tiny corpus (one 160-px train scene and one val scene at 2
  spp, so every spp variant of the loaders has the same sample count and
  an epoch is one step of 4 patches): ``train_kpcn --device cpu`` (KPCN
  ksize 5 without the path buffer) for one epoch with ``--visual`` (latest
  and best checkpoints, the JSONL log), a resume with ``--start_epoch 1`` from the saved state
  (bit for bit), and ``test_models`` serving the result
  (``test_torch_entry_sample.py`` runs ``train_lbmc`` and ``train_sbmc``);
  ``python -m wcmc_tpu_torch.train_kpcn`` as a script.  And the PNG and
  PFM writers.
"""

import argparse
import json
import os
import runpy
import subprocess
import sys

import numpy as np
import pytest
import torch

from wcmc_tpu_torch import test_models, train_kpcn, train_lbmc, train_sbmc
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

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENTRIES = {"train_kpcn.py": train_kpcn, "train_lbmc.py": train_lbmc,
           "train_sbmc.py": train_sbmc}


class _Stop(Exception):
    pass


def _root_parser(script):
    """The root script's parser, as it stands when it would parse."""
    def stop(self, *a, **kw):
        raise _Stop(self)

    orig = argparse.ArgumentParser.parse_args
    argparse.ArgumentParser.parse_args = stop
    try:
        runpy.run_path(os.path.join(REPO, script), run_name="__main__")
    except _Stop as e:
        return e.args[0]
    finally:
        argparse.ArgumentParser.parse_args = orig
    raise AssertionError(f"{script} never parsed its arguments")


def _options(parser):
    return {a.dest: (tuple(a.option_strings), a.default, a.type, a.required, a.nargs,
                     tuple(a.choices) if a.choices else None, type(a).__name__)
            for a in parser._actions if a.dest != "help"}


@pytest.mark.parametrize("script", sorted(ENTRIES))
def test_flags_match_root_script(script):
    want = _options(_root_parser(script))
    got = _options(ENTRIES[script].build_parser())
    assert set(got) == set(want) | {"device"}
    for dest, spec in want.items():
        assert got[dest] == spec, dest
    assert got["device"][:2] == (("--device",), None)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("corpus"))
    build_synthetic_dataset(root, n_train=1, n_val=1, n_test=1, size=160, spp=2,
                            test_extra_parts=0, seed=4)
    for mode in ("train", "val"):
        offline_preprocess(root, mode=mode, spp=8, sbmc=True, device="cpu")
    offline_preprocess(root, mode="test", spp=2, sbmc=True, test_spps=(2,), device="cpu")
    return root


def _argv(corpus, save, name, *extra):
    return ["--single_gpu", "--batch_size", "4", "--patches_per_image", "1",
            "--data_dir", corpus, "--model_name", name, "--desc", "entry test",
            "--save", save, "--compute_dtype", "float32", "--device", "cpu", *extra]


def test_train_kpcn_trains_checkpoints_resumes_and_serves(corpus, tmp_path):
    save = str(tmp_path / "w")
    argv = _argv(corpus, save, "KPCN_entry", "--kpcn_ksize", "5", "--train_branches",
                 "--visual")
    ifaces, params = train_kpcn.main(train_kpcn.parse_args(argv + ["--num_epoch", "1"]))
    assert [s["steps"] for s in params["epoch_stats"]] == [1]
    for fn in ("latest_KPCN_entry.ckpt", "KPCN_entry.ckpt"):
        ck = load_checkpoint(os.path.join(save, fn))
        assert ck["start_epoch"] == 1 and ck["model"] == "KPCNInterface"
    logs = os.path.join(save, "logs", "KPCN_entry")
    recs = [json.loads(line) for line in open(os.path.join(logs, "metrics.jsonl"))]
    assert any("perf/loader_wait_s" in r for r in recs)
    assert not os.path.exists(os.path.join(logs, "pbuf"))   # no path buffer, no dumps
    best = ifaces[0].best_err
    assert 0 < best < 1e10

    # a second run from scratch over the saved model refuses
    with pytest.raises(FileExistsError):
        train_kpcn.main(train_kpcn.parse_args(argv + ["--num_epoch", "1"]))
    # resume: the saved state, then one more epoch
    resumed, _ = train_kpcn.init_model(None, train_kpcn.parse_args(
        argv + ["--num_epoch", "2", "--start_epoch", "1", "--lr_ckpt"]), "cpu")
    for name, m in ifaces[0].models.items():
        for p, q in zip(m.parameters(), resumed[0].models[name].parameters()):
            assert torch.equal(p, q)
            st, rt = (i.optims["optim_" + name].adam.state for i in (ifaces[0], resumed[0]))
            assert torch.equal(st[p]["exp_avg_sq"], rt[q]["exp_avg_sq"])
    assert resumed[0].best_err == best
    # (--val_epoch 3: the resumed epoch skips validation)
    ifaces, params = train_kpcn.main(train_kpcn.parse_args(
        argv + ["--num_epoch", "2", "--start_epoch", "1", "--val_epoch", "3"]))
    assert [s["epoch"] for s in params["epoch_stats"]] == [1]
    assert load_checkpoint(os.path.join(save, "latest_KPCN_entry.ckpt"))["start_epoch"] == 2

    results, _ = test_models.main(test_models.parse_args([
        "--model_name", "KPCN_entry", "--save", save, "--data_dir", corpus, "--spps", "2",
        "--kpcn_ksize", "5", "--compute_dtype", "float32",
        "--device", "cpu", "--output_dir", str(tmp_path / "eval")]))
    res = results[("scene0", 2)]["output"]
    assert all(np.isfinite(v) for v in res.values())


def test_entry_module_runs_as_a_script():
    """``python -m wcmc_tpu_torch.train_kpcn --help`` lists ``--device``;
    inconsistent manifold flags refuse before any work."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-m", "wcmc_tpu_torch.train_kpcn", "--help"],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0 and "--device" in proc.stdout
    with pytest.raises(RuntimeError, match="llpm-specific buffer"):
        train_kpcn.parse_args(["--desc", "x", "--manif_learn", "--device", "cpu"])


def test_png_and_pfm_writers(tmp_path):
    iio = pytest.importorskip("imageio.v3")
    from wcmc_tpu.utils import img_utils as jimg

    rng = np.random.default_rng(0)
    for shape in [(17, 23), (17, 23, 3), (9, 5, 4), (9, 5, 2)]:
        a = rng.integers(0, 256, shape, dtype=np.uint8)
        img_utils.write_png(str(tmp_path / "a.png"), a)
        np.testing.assert_array_equal(iio.imread(str(tmp_path / "a.png")), a)
        iio.imwrite(str(tmp_path / "b.png"), a)
        np.testing.assert_array_equal(img_utils.read_png(str(tmp_path / "b.png")), a)
    f = rng.random((6, 7, 3), dtype=np.float32) * 1.2 - 0.1
    img_utils.write_img(str(tmp_path / "f.png"), f)
    np.testing.assert_array_equal(iio.imread(str(tmp_path / "f.png")),
                                  (np.clip(f, 0.0, 1.0) * 255).astype(np.uint8))
    for img in (f, f[..., 0]):
        img_utils.write_pfm(str(tmp_path / "t.pfm"), img)
        jimg.write_pfm(str(tmp_path / "j.pfm"), img)
        assert (tmp_path / "t.pfm").read_bytes() == (tmp_path / "j.pfm").read_bytes()
        back, scale = img_utils.read_pfm(str(tmp_path / "j.pfm"))
        np.testing.assert_array_equal(back, img)
        assert scale == 1.0
    img_utils.write_csv(str(tmp_path / "c.csv"), [[1, 2]], header=["a", "b"])
    assert (tmp_path / "c.csv").read_text() == "a,b\n1,2\n"
    img_utils.write_json(str(tmp_path / "j.json"), {"x": np.float32(0.5), "y": np.arange(2)})
    assert json.loads((tmp_path / "j.json").read_text()) == {"x": 0.5, "y": [0, 1]}


def test_chip_smoke_cli_argv_parses():
    """``chip_smoke.py``'s CLI phases hand each entry module argv it
    accepts, at the flagship widths (K 21, bf16, batch 8)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  os.path.join(REPO, "chip_smoke.py"))
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    for family, spec in cs.CLI.items():
        mod = ENTRIES[spec["module"] + ".py"]
        args = mod.parse_args(["--single_gpu", "--batch_size", "8", "--desc", "x",
                               "--use_llpm_buf", "--manif_learn", "--manif_loss", "FMSE",
                               "--device", "cuda:0", *spec["args"], *spec.get("resume", ())])
        cfg = mod.make_config(args)
        assert (cfg.base_model, cfg.compute_dtype, args.batch_size) == (family, "bfloat16", 8)
        assert cfg.kpcn_ksize == cfg.sbmc_ksize == 21
    assert set(cs.CLI) == set(cs.TRAIN_LAUNCHES)
