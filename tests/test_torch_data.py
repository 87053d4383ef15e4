"""Port parity: ``mmdyn_tpu_torch.data`` against ``mmdyn_tpu.data``, on small
synthetic corpora written by both packages from the same seed."""

import re
import threading

import numpy as np
import pytest
import torch

import jax

from mmdyn_tpu.data import compile as jcompile
from mmdyn_tpu.data import dataset as jdataset
from mmdyn_tpu.data import loader as jloader
from mmdyn_tpu.data.synthetic import make_compiled_arrays as jax_make_compiled_arrays

from mmdyn_tpu_torch.data import compile as tcompile
from mmdyn_tpu_torch.data import dataset as tdataset
from mmdyn_tpu_torch.data import loader as tloader
from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays

N, T = 12, 3


def _per_sequence(arrays):
    return {k: v for k, v in arrays.items() if np.ndim(v) > 0 and v.shape[0] == N}


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """A JAX-written npz corpus with a shock condition, and its arrays."""
    root = tmp_path_factory.mktemp("ds")
    path = jax_make_compiled_arrays(root / jcompile.COMPILED_NAME, n_sequences=N,
                                    seq_length=T, with_shock=True, seed=4)
    return root, jcompile.load_packed(path)


def test_names_match():
    assert tcompile.COMPILED_NAME == jcompile.COMPILED_NAME
    assert tcompile.NOCROP_NAME == jcompile.NOCROP_NAME
    for crop in (True, False):
        assert tcompile.compiled_name_for(crop) == jcompile.compiled_name_for(crop)


@pytest.mark.parametrize("fmt", ["npz", "packed_dir"])
def test_load_packed_reads_the_jax_formats(corpus, tmp_path, fmt):
    """The port reads both formats the JAX package writes, array for array."""
    _, want = corpus
    if fmt == "npz":
        path = jax_make_compiled_arrays(tmp_path / "c.npz", n_sequences=N, seq_length=T,
                                        with_shock=True, seed=4)
    else:
        path = jcompile.save_packed_dir(tmp_path / "c", want)
    _assert_same_arrays(tcompile.load_packed(path), want)


@pytest.mark.parametrize("packed_dir", [False, True])
@pytest.mark.parametrize("with_shock", [False, True])
def test_make_compiled_arrays_matches_jax(tmp_path, packed_dir, with_shock):
    want = jcompile.load_packed(jax_make_compiled_arrays(
        tmp_path / "j.npz", n_sequences=5, seq_length=2, with_shock=with_shock, seed=9))
    path = make_compiled_arrays(tmp_path / "t.npz", n_sequences=5, seq_length=2,
                                with_shock=with_shock, seed=9, packed_dir=packed_dir)
    assert path.is_dir() == packed_dir
    _assert_same_arrays(tcompile.load_packed(path), want)
    # the JAX reader reads the port's packed directory too
    _assert_same_arrays(jcompile.load_packed(path), want)


def test_missing_corpus_names_the_file(tmp_path):
    """No corpus and no dumps: the compile that the missing corpus starts
    names the dump directory it searched, as the JAX package's does."""
    msg = re.escape(f"no data.json under {tmp_path / 'dataset'}")
    for package in (tdataset, jdataset):
        with pytest.raises(AssertionError, match=msg):
            package.VisuoTactileArrays(tmp_path, crop=False)
    assert not (tmp_path / tcompile.NOCROP_NAME).exists()


@pytest.mark.parametrize("train", [True, False])
def test_splits_and_norms_match_jax(corpus, train):
    root, _ = corpus
    want = jdataset.VisuoTactileArrays(root, train=train)
    got = tdataset.VisuoTactileArrays(root, train=train)
    assert len(got) == len(want) == (9 if train else 2)   # 80/20, test drops the last
    _assert_same_arrays(got.arrays, want.arrays)
    assert got.norms == want.norms and "shock_min" in got.norms
    assert (got.seq_length, got.has_shock, got.crop, got.shock_dim) == \
        (want.seq_length, want.has_shock, want.crop, want.shock_dim) == (T, True, True, 1)


@pytest.mark.parametrize("problem_type,mask_loss", [("seq_modeling", False),
                                                    ("dyn_modeling", True)])
def test_dataset_setup_matches_jax(corpus, problem_type, mask_loss):
    root, _ = corpus
    want = jdataset.dataset_setup(root, problem_type, batchsize=3, seed=2, mask_loss=mask_loss)
    got = tdataset.dataset_setup(root, problem_type, batchsize=3, seed=2, mask_loss=mask_loss)
    assert got["seq_length"] == want["seq_length"]
    for split in ("train_loader", "test_loader"):
        g, w = got[split], want[split]
        assert (len(g), g.frames, g.shuffle, sorted(g.arrays)) == \
            (len(w), w.frames, w.shuffle, sorted(w.arrays))
        for bg, bw in zip(g, w):
            _assert_same_arrays(bg, bw)


@pytest.mark.parametrize("frames,skip,procs", [
    (None, (), 1), (1, ("seg",), 1), (2, (), 1), (None, ("seg", "pose"), 3),
    (1, (), 3)])
def test_batch_loader_matches_jax_over_epochs(corpus, frames, skip, procs):
    """The same seed gives the JAX loader's batches, index for index, over
    three epochs; with process blocks each process's rows too; and a loader
    pinned to epoch 2 replays that epoch."""
    _, arrays = corpus
    arrays = _per_sequence(arrays)
    for p in range(procs):
        kw = dict(shuffle=True, seed=5, frames=frames, skip=skip)
        if procs > 1:
            kw.update(process_index=p, process_count=procs)
        want = jloader.BatchLoader(arrays, 6, **kw)
        got = tloader.BatchLoader(arrays, 6, **kw)
        assert len(got) == len(want) == 2
        epochs = []
        for _ in range(3):
            batches = list(got)
            for bg, bw in zip(batches, want, strict=True):
                _assert_same_arrays(bg, bw)
            epochs.append(batches)
        replay = tloader.BatchLoader(arrays, 6, **kw)
        replay.set_epoch(2)
        for bg, bw in zip(replay, epochs[2], strict=True):
            _assert_same_arrays(bg, bw)
    with pytest.raises(ValueError, match="divide evenly"):
        tloader.BatchLoader(arrays, 5, process_index=0, process_count=2)


def test_to_device_batch_scales_uint8_images(corpus):
    """uint8 image keys become float32 / 255, as the JAX package's do; other
    keys keep their values."""
    _, arrays = corpus
    batch = next(iter(tloader.BatchLoader(_per_sequence(arrays), 4, seed=1)))
    got = tloader.to_device_batch(batch, "cpu")
    want = jloader.to_device_batch(batch)
    for k, v in batch.items():
        assert got[k].dtype == torch.float32, k
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]), rtol=1e-7, err_msg=k)
        if v.dtype == np.uint8:
            np.testing.assert_array_equal(got[k].numpy(), v.astype(np.float32) / 255.0)


def test_device_prefetch_yields_every_batch_and_reraises():
    batches = [{"visual": np.full((2, 1, 4, 4, 3), i, np.uint8),
                "pose": np.full((2, 1, 7), i, np.float32)} for i in range(5)]
    got = list(tloader.device_prefetch(iter(batches), "cpu", size=2))
    assert len(got) == 5
    for i, b in enumerate(got):
        assert torch.equal(b["visual"], torch.full((2, 1, 4, 4, 3), i / 255.0))
        assert torch.equal(b["pose"], torch.full((2, 1, 7), float(i)))

    def failing():
        yield batches[0]
        raise RuntimeError("producer failed")

    it = tloader.device_prefetch(failing(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="producer failed"):
        next(it)


def test_device_prefetch_closed_early_stops_its_thread():
    """A consumer that leaves after one batch, as a SIGTERM break does: on
    ``close()`` the producer, blocked for room ``size`` batches ahead, wakes,
    stops pulling from the source and ends."""
    pulled = []

    def source():
        for i in range(100):
            pulled.append(i)
            yield {"pose": np.full((2, 1, 7), i, np.float32)}

    it = tloader.device_prefetch(source(), "cpu", size=2)
    assert float(next(it)["pose"][0, 0, 0]) == 0.0
    it.close()
    for t in threading.enumerate():
        if t.name == "device_prefetch":
            t.join(timeout=10)
    assert not [t for t in threading.enumerate() if t.name == "device_prefetch"]
    assert len(pulled) <= 5, pulled


def test_process_grid_without_torch_distributed():
    assert tdataset.process_grid() == (0, 1)
    assert jax.process_count() == 1
