"""The port's ``DeviceCorpus`` against ``wcmc_tpu``'s on the CPU: the same
frames and the same ``np.random.Generator`` give the same coordinates and
the same patches, bit for bit (a crop is a copy).  The cases mirror
``tests/test_device_corpus.py``."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from wcmc_tpu.data.device_corpus import DeviceCorpus as JaxCorpus
from wcmc_tpu_torch.data.device_corpus import DeviceCorpus


def _frames(n=3, h=16, w=20, seed=0):
    rng = np.random.default_rng(seed)
    return [
        {
            "img": rng.standard_normal((1, h, w, 2)).astype(np.float32),
            "samp": rng.standard_normal((1, 4, h, w, 3)).astype(np.float32),
        }
        for _ in range(n)
    ]


def _equal(batch, want):
    assert batch.keys() == want.keys()
    for k in want:
        got, ref = batch[k], np.asarray(want[k])
        if ref.dtype == jnp.bfloat16:
            assert got.dtype == torch.bfloat16
            got, ref = got.float().numpy(), ref.astype(np.float32)
        else:
            got = got.numpy()
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)


def test_crop_matches_the_reference_and_numpy_slices():
    frames = _frames()
    corpus = DeviceCorpus(frames, patch=8, device="cpu")
    ids, ys, xs = np.array([2, 0, 1]), np.array([3, 8, 0]), np.array([5, 0, 12])
    batch = corpus.crop(ids, ys, xs)
    assert batch["img"].shape == (3, 8, 8, 2)
    assert batch["samp"].shape == (3, 4, 8, 8, 3)
    assert all(v.is_contiguous() for v in batch.values())
    _equal(batch, JaxCorpus(frames, patch=8).crop(ids, ys, xs))
    for j, (i, y, x) in enumerate(zip(ids, ys, xs)):
        np.testing.assert_array_equal(batch["samp"][j].numpy(),
                                      frames[i]["samp"][0, :, y:y + 8, x:x + 8])


def test_crop_refuses_crops_outside_the_corpus():
    corpus = DeviceCorpus(_frames(), patch=8, device="cpu")
    for ids, ys, xs in (([3], [0], [0]), ([0], [9], [0]), ([0], [0], [13]), ([0], [-1], [0]),
                        ([0, 1], [0], [0])):
        with pytest.raises(ValueError):
            corpus.crop(np.array(ids), np.array(ys), np.array(xs))


def test_uniform_coords_and_batches_match_the_reference():
    frames = _frames()
    corpus, ref = DeviceCorpus(frames, patch=8, device="cpu"), JaxCorpus(frames, patch=8)
    rng, ref_rng = np.random.default_rng(1), np.random.default_rng(1)
    for _ in range(3):
        np.testing.assert_array_equal(corpus.sample_coords(rng, 5),
                                      ref.sample_coords(ref_rng, 5))
    b, b2 = corpus.sample_batch(rng, 4), corpus.sample_batch(rng, 4)
    _equal(b, ref.sample_batch(ref_rng, 4))
    assert not torch.equal(b["img"], b2["img"])   # fresh patches


def test_importance_coords_match_the_reference():
    """Importance maps smaller than the offset grid (as ``_prob_imp`` maps
    are: H - 128 rows for H - 127 offsets) and one map with no mass (uniform
    over its offsets)."""
    frames = _frames(n=3, h=16, w=20)
    rng = np.random.default_rng(7)
    imps = [rng.random((8, 12)), rng.random((9, 13)) ** 4, np.zeros((8, 12))]
    corpus = DeviceCorpus(frames, patch=8, importance=imps, device="cpu")
    ref = JaxCorpus(frames, patch=8, importance=imps)
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    for _ in range(4):
        coords = corpus.sample_coords(a, 6)
        np.testing.assert_array_equal(coords, ref.sample_coords(b, 6))
        _equal(corpus.crop(*coords), ref.crop(*coords))


def test_importance_sampling_concentrates():
    frames = _frames(n=2)
    imp = np.zeros((16 - 8 + 1, 20 - 8 + 1))
    imp[1, 2] = 1.0
    corpus = DeviceCorpus(frames, patch=8, importance=[imp, imp], device="cpu")
    coords = corpus.sample_coords(np.random.default_rng(2), 3)
    assert (coords[1:] == np.array([[1], [2]])).all()
    with pytest.raises(ValueError):
        DeviceCorpus(frames, patch=8, importance=[imp], device="cpu")


@pytest.mark.parametrize("batch_size,stride,n_batches", [(2, None, 4), (3, None, 3), (4, 4, 5)])
def test_grid_batches_match_the_reference(batch_size, stride, n_batches):
    """2 scenes x a 2 x 2 grid (stride 8) or 3 x 3 grid (stride 4) of
    patches, the ragged tail flushed as a last, smaller batch."""
    frames = _frames(n=2, h=16, w=16)
    got = list(DeviceCorpus(frames, patch=8, device="cpu").grid_batches(batch_size, stride))
    want = list(JaxCorpus(frames, patch=8).grid_batches(batch_size, stride))
    assert len(got) == len(want) == n_batches
    for b, w in zip(got, want):
        _equal(b, w)


def test_cast_to_bf16_on_the_host():
    frames = _frames()
    corpus = DeviceCorpus(frames, patch=8, device="cpu",
                          cast=lambda k, v: v.to(torch.bfloat16) if k == "samp" else v)
    ref = JaxCorpus(frames, patch=8,
                    cast=lambda k, v: v.astype(ml_dtypes.bfloat16) if k == "samp" else v)
    assert corpus.frames["samp"].dtype == torch.bfloat16
    assert corpus.frames["img"].dtype == torch.float32
    assert corpus.nbytes() == ref.nbytes() == 3 * (16 * 20 * 2 * 4 + 4 * 16 * 20 * 3 * 2)
    coords = np.array([[1, 2], [0, 5], [4, 1]])
    _equal(corpus.crop(*coords), ref.crop(*coords))


def test_frames_given_as_tensors():
    """Tensor frames are concatenated where they lie, without the cast (as
    the reference keeps device arrays), and crop as the numpy frames do."""
    frames = _frames()
    tensors = [{k: torch.from_numpy(v) for k, v in f.items()} for f in frames]
    corpus = DeviceCorpus(tensors, patch=8, device="cpu",
                          cast=lambda k, v: v.to(torch.bfloat16))
    assert all(v.dtype == torch.float32 for v in corpus.frames.values())
    ref = JaxCorpus([{k: jnp.asarray(v) for k, v in f.items()} for f in frames], patch=8)
    coords = np.array([[2, 1], [8, 0], [0, 12]])
    _equal(corpus.crop(*coords), ref.crop(*coords))
    _equal(corpus.crop(*coords), DeviceCorpus(frames, patch=8, device="cpu").crop(*coords))


def test_empty_corpus_raises():
    with pytest.raises(ValueError):
        DeviceCorpus([], patch=8, device="cpu")
