"""The port's epoch loop (``wcmc_tpu_torch/train/loop.py``), its
prefetcher and step timer: every case of ``tests/test_loop.py`` on the
port, and one cross-package run.

The cross-package run: wcmc_tpu's ``train()`` and the port's, 2 epochs of
2 steps each, KPCN (ksize 5, the dual PathNet, no manifold loss) in f32
from the same initial parameters over the same batches.  The validation
summaries and ``best_err`` agree within 1e-5 relative; each model's final
parameters within 1e-5 of their norm by relative L2 and within 2 lr a
step everywhere (an Adam step moves a parameter by about lr whatever its
gradient, so where a gradient is within rounding of zero the two runs
can step apart by that much; see ``test_torch_train_step.py``).
"""

import types

import jax
import numpy as np
import pytest
import torch

from wcmc_tpu.data.batches import synthetic_batch as jsynth
from wcmc_tpu.train import loop as jloop
from wcmc_tpu.train.factory import TrainConfig as JConfig
from wcmc_tpu.train.factory import init_interfaces as jinit
from wcmc_tpu_torch import convert
from wcmc_tpu_torch.data.batches import synthetic_batch
from wcmc_tpu_torch.data.prefetch import DevicePrefetcher
from wcmc_tpu_torch.train import loop
from wcmc_tpu_torch.train.checkpoint import load_checkpoint
from wcmc_tpu_torch.train.factory import TrainConfig, init_interfaces
from wcmc_tpu_torch.train.loop import step_lr, train
from wcmc_tpu_torch.train.state import get_learning_rate
from wcmc_tpu_torch.utils.observability import MetricsWriter, StepTimer, maybe_profile


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads: a parallel test run shares the cores among its
    workers, and more threads a worker mostly spin."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


class ListLoader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


def _args(tmp_path, **kw):
    defaults = dict(save=str(tmp_path / "weights"), model_name="LOOP_test", num_epoch=2,
                    start_epoch=0, val_epoch=1, not_save=False, desc="loop test",
                    visual=False)
    defaults.update(kw)
    return types.SimpleNamespace(**defaults)


def _iface():
    cfg = TrainConfig(base_model="kpcn", kpcn_ksize=5, finite_check_every=1,
                      compute_dtype="float32")
    return init_interfaces(cfg, device="cpu")[0]


def _batch(seed=1234):
    return synthetic_batch(np.random.default_rng(seed), "kpcn", batch_size=2, patch=48, spp=2)


def test_step_lr_schedule():
    sched = step_lr(1e-3, step_size=3, gamma=0.5)
    # StepLR semantics: lr halves after every 3 completed epochs
    assert sched(0) == pytest.approx(1e-3)
    assert sched(1) == pytest.approx(1e-3)
    assert sched(2) == pytest.approx(5e-4)
    assert sched(5) == pytest.approx(2.5e-4)


@pytest.mark.parametrize("case", ["checkpoints_and_best", "scheduler_applied",
                                  "with_prefetcher", "not_save"])
def test_train_loop(tmp_path, case):
    iface = _iface()
    batch = _batch()
    loaders = {"train": ListLoader([batch]), "val": ListLoader([batch])}
    args = _args(tmp_path, model_name=f"LOOP_{case}")
    params = {}
    if case == "scheduler_applied":
        args.num_epoch = 3
        params["sched_dncnn"] = step_lr(1e-4, step_size=1, gamma=0.1)
    if case == "with_prefetcher":
        host = {k: v.numpy() for k, v in batch.items()}
        loaders = {"train": DevicePrefetcher(ListLoader([host, host]), device="cpu"),
                   "val": DevicePrefetcher(ListLoader([host]), device="cpu")}
        args.num_epoch = 1
    if case == "not_save":
        args.not_save, args.num_epoch = True, 1
    train([iface], loaders, params, args, verbose=False)

    wdir = tmp_path / "weights"
    if case == "not_save":
        assert not (wdir / f"latest_{args.model_name}.ckpt").exists()
        return
    assert iface.best_err < 1e10                   # updated from the sentinel
    assert [s["steps"] for s in params["epoch_stats"]] == [len(loaders["train"])] * args.num_epoch
    if case == "checkpoints_and_best":
        assert (wdir / "latest_LOOP_checkpoints_and_best.ckpt").is_file()
        assert (wdir / "LOOP_checkpoints_and_best.ckpt").is_file()     # best saved
        ck = load_checkpoint(str(wdir / "latest_LOOP_checkpoints_and_best.ckpt"))
        assert ck["start_epoch"] == 2
        assert "state_dict_dncnn" in ck and "optim_dncnn" in ck
    if case == "scheduler_applied":
        # after 3 epochs with gamma 0.1/epoch: lr = 1e-4 * 0.1^3
        assert get_learning_rate(iface.optims["optim_dncnn"]) == pytest.approx(1e-7, rel=1e-3)


def test_device_prefetcher():
    rng = np.random.default_rng(0)
    batches = [{"x": rng.random((2, 4, 4, 3)).astype(np.float32),
                "i": np.full((1,), i, np.int64)} for i in range(5)]
    pf = DevicePrefetcher(ListLoader(batches), depth=2, device="cpu")
    assert len(pf) == 5
    out = list(pf)
    assert len(out) == 5
    for a, b in zip(out, batches):
        assert isinstance(a["x"], torch.Tensor) and a["x"].device.type == "cpu"
        np.testing.assert_array_equal(a["x"].numpy(), b["x"])
        np.testing.assert_array_equal(a["i"].numpy(), b["i"])

    class Boom:            # exceptions from the loader propagate
        def __len__(self):
            return 1

        def __iter__(self):
            yield batches[0]
            raise RuntimeError("boom")

    it = iter(DevicePrefetcher(Boom(), device="cpu"))
    next(it)
    with pytest.raises(RuntimeError, match="boom"):
        next(it)
    # a consumer that stops early stops the producer
    it = iter(DevicePrefetcher(ListLoader(batches * 10), depth=1, device="cpu"))
    next(it)
    it.close()


def test_device_prefetcher_serves_bfloat16():
    ml_dtypes = pytest.importorskip("ml_dtypes")
    x = np.random.default_rng(1).random((3, 5), dtype=np.float32)
    host = {"paths": x.astype(ml_dtypes.bfloat16)}
    (got,) = list(DevicePrefetcher(ListLoader([host]), device="cpu"))
    assert got["paths"].dtype == torch.bfloat16
    np.testing.assert_array_equal(got["paths"].float().numpy(),
                                  host["paths"].astype(np.float32))


def test_in_flight_window_preserves_results(tmp_path, monkeypatch):
    """The bounded run-ahead window (WCMC_TRAIN_IN_FLIGHT) changes only
    when the host reads back: a 1-deep window trains as no window."""
    def run(window):
        monkeypatch.setenv("WCMC_TRAIN_IN_FLIGHT", window)
        iface = _iface()
        batch = _batch(7)
        loaders = {"train": ListLoader([batch, batch]), "val": ListLoader([batch])}
        args = _args(tmp_path, model_name=f"LOOP_if{window}", num_epoch=1)
        train([iface], loaders, {}, args, verbose=False)
        return iface.best_err

    assert run("0") == pytest.approx(run("1"), rel=1e-6)


def test_step_timer_snapshot_does_not_drain():
    t = StepTimer()
    t.tick(); t.tick()
    snap = t.snapshot_ms()
    assert len(snap) == len(t.snapshot_ms())  # snapshot is repeatable
    drained = t.drain_all_ms()
    assert drained == snap                    # same history, then cleared
    assert t.drain_all_ms() == []


def test_metrics_writer_and_profile(tmp_path):
    w = MetricsWriter(str(tmp_path / "logs"), use_tensorboard=False)
    w.log(3, {"l": torch.tensor(0.5)}, prefix="train/")
    w.close()
    import json

    rec = json.loads((tmp_path / "logs" / "metrics.jsonl").read_text())
    assert rec["step"] == 3 and rec["train/l"] == 0.5
    with maybe_profile(None) as prof:
        assert prof is None
    with maybe_profile(str(tmp_path / "prof")):
        torch.ones(8).sum()
    summary = json.loads((tmp_path / "prof" / "summary.json").read_text())
    assert (tmp_path / "prof" / "trace.json").is_file() and summary["wall_ms"] > 0


def test_train_matches_jax_train(tmp_path, monkeypatch):
    """wcmc_tpu's train() and the port's: 2 epochs of 2 steps, the same
    initial parameters and batches (f32, no manifold loss)."""
    lr = 1e-4
    cfg = dict(base_model="kpcn", kpcn_ksize=5, use_llpm_buf=True, compute_dtype="float32",
               finite_check_every=1, lr_dncnn=lr, lr_pnet=(lr,))
    jif = jinit(JConfig(**cfg))[0]
    tif = init_interfaces(TrainConfig(**cfg, seed=1), device="cpu")[0]
    for name, st in jif.states.items():
        convert.load_flax_params(tif.models[name], st.params)
    # batch seed 1: no relu pre-activation within rounding of zero
    jb = jsynth(np.random.default_rng(1), "kpcn", batch_size=2, patch=48, spp=2,
                use_llpm_buf=True)
    tb = synthetic_batch(np.random.default_rng(1), "kpcn", batch_size=2, patch=48, spp=2,
                         use_llpm_buf=True)
    summaries = {"jax": [], "torch": []}
    for name, mod in (("jax", jloop), ("torch", loop)):
        validate = mod.validate

        def recorded(*a, _v=validate, _n=name, **kw):
            out = _v(*a, **kw)
            summaries[_n].append(out[0])
            return out

        monkeypatch.setattr(mod, "validate", recorded)
    jloop.train([jif], {"train": ListLoader([jb, jb]), "val": ListLoader([jb])}, {},
                _args(tmp_path / "jax", model_name="KPCN_loop"), verbose=False)
    loop.train([tif], {"train": ListLoader([tb, tb]), "val": ListLoader([tb])}, {},
               _args(tmp_path / "torch", model_name="KPCN_loop"), verbose=False)
    assert len(summaries["jax"]) == len(summaries["torch"]) == 2
    np.testing.assert_allclose(summaries["torch"], summaries["jax"], rtol=1e-5)
    assert tif.best_err == pytest.approx(jif.best_err, rel=1e-5)
    for name, model in tif.models.items():
        got = [x.ravel() for x in jax.tree_util.tree_leaves(convert.to_flax(model))]
        want = [np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(jif.states[name].params)]
        got, want = np.concatenate(got), np.concatenate(want)
        assert np.abs(got - want).max() <= 2 * 4 * lr
        assert np.linalg.norm(got - want) <= 1e-5 * np.linalg.norm(want), name
