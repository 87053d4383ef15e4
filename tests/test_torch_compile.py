"""Port parity: compiling simulator dumps into a corpus
(``mmdyn_tpu_torch.data.compile``, ``data/native.py``,
``data/synthetic.py::make_synthetic_dumps``, ``cli/make_synthetic.py``, and
the compile that a missing corpus starts in the dataset and the training
CLI) against ``mmdyn_tpu.data`` on the CPU, on small dump trees written by
both packages from one seed. Tolerances: the PIL compile equals the JAX
package's bit for bit; the native engine is within 1 of PIL on uint8 keys
and equal on the others, as ``tests/test_data.py`` holds the JAX engines."""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest

from mmdyn_tpu.data import compile as jcompile
from mmdyn_tpu.data.synthetic import make_synthetic_dumps as jax_make_synthetic_dumps

from mmdyn_tpu_torch.cli import main as cli_main
from mmdyn_tpu_torch.cli import make_synthetic as cli_make_synthetic
from mmdyn_tpu_torch.data import compile as tcompile
from mmdyn_tpu_torch.data import dataset as tdataset
from mmdyn_tpu_torch.data import native
from mmdyn_tpu_torch.data.synthetic import make_synthetic_dumps
from tests.torch_threads import one_torch_thread  # noqa: F401

SIZE = (60, 80)        # dump frames (H, W); the compile resizes to 256, then 64


def _files(root):
    return sorted(p.relative_to(root) for p in root.rglob("*") if p.is_file())


def _assert_same_arrays(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype, k
        np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.fixture(scope="module")
def dumps(tmp_path_factory):
    """Dump trees written by the JAX package, without and with a shock."""
    out = {}
    for shock in (False, True):
        root = tmp_path_factory.mktemp(f"dumps_{int(shock)}")
        jax_make_synthetic_dumps(root, n_sequences=4, seq_length=6, image_size=SIZE,
                                 with_shock=shock, seed=3)
        out[shock] = root
    return out


def _copy(src, dst):
    shutil.copytree(src / "dataset", dst / "dataset")
    return dst


@pytest.mark.parametrize("shock", [False, True])
def test_dump_trees_are_byte_identical(dumps, tmp_path, shock):
    got = make_synthetic_dumps(tmp_path, n_sequences=4, seq_length=6, image_size=SIZE,
                               with_shock=shock, seed=3)
    want = dumps[shock] / "dataset"
    assert got == tmp_path / "dataset"
    assert _files(got) == _files(want) and len(_files(got)) == 4 * (3 * 6 + 1)
    for rel in _files(want):
        assert (got / rel).read_bytes() == (want / rel).read_bytes(), rel


@pytest.mark.parametrize("shock,crop,strict,name", [
    (False, True, True, tcompile.COMPILED_NAME),
    (False, False, True, tcompile.NOCROP_NAME),
    (False, True, False, tcompile.COMPILED_NAME),
    (False, False, False, "packed_nocrop"),
    (True, True, True, tcompile.COMPILED_NAME),
    (True, False, False, tcompile.NOCROP_NAME),
])
def test_compile_pil_matches_jax_bit_for_bit(dumps, tmp_path, shock, crop, strict, name):
    """Every key of the port's PIL compile equals the JAX compile's, for crop
    and no-crop, strict and not, with and without a shock, into an npz or a
    packed directory."""
    kw = dict(strict_parity=strict, seed=5, verbose=False, engine="pil", crop=crop)
    root = dumps[shock]
    want = jcompile.load_packed(jcompile.compile_dataset(root, compiled_name="j_" + name, **kw))
    path = tcompile.compile_dataset(root, compiled_name="t_" + name, **kw)
    assert path == root / ("t_" + name) and path.is_dir() == (not name.endswith(".npz"))
    got = tcompile.load_packed(path, mmap=False)
    _assert_same_arrays(got, want)
    assert got["visual"].shape == (3 if strict else 4, 6, 64, 64, 3)
    assert bool(got["crop"]) == crop and bool(got["has_shock"]) == shock
    assert ("shock" in got) == shock


def test_compile_sv_path_duplicates_like_jax(dumps, tmp_path):
    """A path naming 'sv' appends each sequence seq_length // 5 times."""
    root = _copy(dumps[True], tmp_path / "sv_corpus")
    kw = dict(seed=2, verbose=False, engine="pil")
    want = jcompile.load_packed(jcompile.compile_dataset(root, compiled_name="j.npz", **kw))
    got = tcompile.load_packed(tcompile.compile_dataset(root, compiled_name="t.npz", **kw))
    _assert_same_arrays(got, want)
    assert got["visual"].shape[0] == 3 * (6 // 5)


def _drop(root, pattern):
    sorted((root / "dataset").glob(pattern))[0].unlink()


def _mix_shock(root):
    path = sorted((root / "dataset").glob("**/data.json"))[1]
    data = json.loads(path.read_text())
    del data["shock"]
    path.write_text(json.dumps(data))


@pytest.mark.parametrize("case,edit,match", [
    ("non-uniform", lambda r: _drop(r, "**/visual_0005.png"), "non-uniform dump"),
    ("ragged", lambda r: _drop(r, "**/tactile_0005.png"), "ragged tactile/seg streams: \\['/"),
    ("unpaired", lambda r: _drop(r, "**/data.json"), "frame/data.json mismatches: \\['/"),
    ("mixed shock", _mix_shock, "mixed corpus"),
])
def test_bad_dumps_raise_the_jax_error(dumps, tmp_path, case, edit, match):
    root = _copy(dumps[True], tmp_path / "bad")
    edit(root)
    errors = []
    for package in (jcompile, tcompile):
        with pytest.raises(ValueError, match=match) as info:
            package.compile_dataset(root, verbose=False, engine="pil")
        errors.append(str(info.value))
    assert errors[0] == errors[1]
    assert not list(root.glob("*.npz"))


def _write_real_captures(root, n=3, seed=0):
    """A seeded tree of real-sensor captures: per trial, visual / tactile
    initial and final PNGs (written with cv2) with a saturated object on a
    grey background, larger than the colour mask's crop."""
    import cv2

    rng = np.random.default_rng(seed)
    for i in range(n):
        for stream in ("visual", "tactile"):
            d = root / "dataset" / f"trial_{i:03d}" / stream
            d.mkdir(parents=True)
            for stage in ("initial", "final"):
                img = np.full((320, 400, 3), 120, np.uint8)
                img += rng.integers(0, 20, size=img.shape, dtype=np.uint8)
                y, x = rng.integers(40, 200), rng.integers(60, 260)
                img[y:y + 60, x:x + 80] = rng.integers(0, 256, size=3, dtype=np.uint8)
                cv2.imwrite(str(d / f"{stage}.png"), img)


def test_compile_real_dataset_matches_jax(tmp_path):
    _write_real_captures(tmp_path)
    want = jcompile.load_packed(jcompile.compile_real_dataset(
        tmp_path, seed=4, compiled_name="j.npz", verbose=False))
    got = tcompile.load_packed(tcompile.compile_real_dataset(
        tmp_path, seed=4, compiled_name="t.npz", verbose=False))
    _assert_same_arrays(got, want)
    assert got["visual"].shape == (3, 1, 64, 64, 3)
    assert got["final_visual"].std() > 0


@pytest.mark.parametrize("crop", [True, False])
def test_native_engine_within_one_of_pil(dumps, crop):
    """The port's native library, built from the unchanged ``native/ingest.cpp``
    into the port's own directory, compiles within 1 of its PIL engine (uint8
    keys; the rest equal). (The JAX package's library is left alone: its own
    tests build it under ``native/build``.)"""
    if not native.available():
        pytest.skip(f"no C++ toolchain: {native.build_error()}")
    lib = Path(native.load()._name)
    assert lib.parent == Path(native.__file__).resolve().parent / "_build"
    assert lib.name == f"libmmdyn_ingest-{native._HOST}.so"   # one build per host
    assert lib.exists() and "native" not in lib.relative_to(Path(__file__).parents[1]).parts
    root = dumps[False]
    kw = dict(seed=1, verbose=False, crop=crop)
    pil = tcompile.load_packed(tcompile.compile_dataset(
        root, compiled_name=f"p{int(crop)}.npz", engine="pil", **kw))
    nat = tcompile.load_packed(tcompile.compile_dataset(
        root, compiled_name=f"n{int(crop)}.npz", engine="native", **kw))
    assert sorted(nat) == sorted(pil)
    for k in pil:
        if pil[k].dtype == np.uint8:
            assert np.abs(pil[k].astype(int) - nat[k].astype(int)).max() <= 1, k
        else:
            np.testing.assert_array_equal(nat[k], pil[k], err_msg=k)
    png = sorted((root / "dataset").glob("**/seg_0000.png"))[0]
    from PIL import Image
    np.testing.assert_array_equal(native.decode_png(png)[..., 0], np.asarray(Image.open(png)))


def test_native_engine_raises_where_the_library_does_not_build(dumps, monkeypatch):
    """``engine="native"`` raises with g++'s message; ``"auto"`` takes PIL."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", "g++: command not found")
    root = dumps[False]
    with pytest.raises(RuntimeError, match="failed to build: g\\+\\+: command not found"):
        tcompile.compile_dataset(root, compiled_name="x.npz", engine="native", verbose=False)
    auto = tcompile.compile_dataset(root, compiled_name="a.npz", engine="auto", seed=0,
                                    verbose=False)
    pil = tcompile.compile_dataset(root, compiled_name="p.npz", engine="pil", seed=0,
                                   verbose=False)
    _assert_same_arrays(tcompile.load_packed(auto), tcompile.load_packed(pil))


@pytest.mark.parametrize("strict", [True, False])
def test_visuotactile_arrays_compile_a_missing_corpus(dumps, tmp_path, strict):
    """As the JAX dataset does, the port's compiles a missing corpus (with
    the compile's unseeded shuffle, so rows are compared as sets with the
    JAX compile of the same dumps)."""
    root = _copy(dumps[False], tmp_path / "ours")
    got = tdataset.VisuoTactileArrays(root, train=True, strict_parity=strict, mmap=False)
    corpus = tcompile.load_packed(root / tcompile.COMPILED_NAME)
    want = jcompile.load_packed(jcompile.compile_dataset(
        dumps[False], strict_parity=strict, compiled_name=f"j_missing{int(strict)}.npz",
        engine="pil", verbose=False))
    n = 3 if strict else 4
    assert corpus["visual"].shape[0] == want["visual"].shape[0] == n
    assert len(got) == int(0.8 * n) and got.seq_length == 6
    assert got.norms == {k: want[k].tolist() for k in ("pose_min", "pose_max")}
    rows = lambda a: sorted(a["final_pose"].tolist())  # noqa: E731
    assert rows(corpus) == rows(want)


def _train_argv(ds, tmp_path, name):
    return ["--problem-type", "seq_modeling", "--model-name", "cnn-vae", "--input-type",
            "visual", "--dataset-path", str(ds), "--batchsize", "4", "--num-epochs", "1",
            "--latent-size", "8", "--no-tensorboard", "--platform", "cpu",
            "--log-dir", str(tmp_path / name)]


def test_cli_main_compiles_dumps_and_trains(tmp_path):
    """``cli.main --platform cpu`` on a dump directory compiles the corpus and
    takes a step; ``--no-strict-parity`` keeps the last sequence."""
    make_synthetic_dumps(tmp_path / "strict", n_sequences=6, seq_length=2, seed=1)
    shutil.copytree(tmp_path / "strict", tmp_path / "loose")
    for ds, extra, n in (("strict", [], 5), ("loose", ["--no-strict-parity"], 6)):
        problem = cli_main.main(_train_argv(tmp_path / ds, tmp_path, f"run_{ds}") + extra)
        corpus = tcompile.load_packed(tmp_path / ds / tcompile.COMPILED_NAME)
        assert corpus["visual"].shape[0] == n
        assert len(problem.train_dataset) == 4 and len(problem.test_dataset) == n - 5
        losses = problem._logger_dict["Loss/train_epoch"]
        assert len(losses) == 1 and np.isfinite(losses).all()


@pytest.mark.parametrize("packed", [False, True])
def test_cli_make_synthetic_matches_jax(tmp_path, packed):
    from mmdyn_tpu.cli import make_synthetic as jax_cli

    argv = ["--n-sequences", "3", "--seq-length", "5", "--with-shock", "--seed", "7"]
    argv += ["--packed"] if packed else []
    jax_cli.main(argv + ["--out", str(tmp_path / "j")])
    out = cli_make_synthetic.main(argv + ["--out", str(tmp_path / "t")])
    assert _files(tmp_path / "t") == _files(tmp_path / "j")
    if packed:
        assert out == tmp_path / "t" / tcompile.COMPILED_NAME
        _assert_same_arrays(tcompile.load_packed(out),
                            jcompile.load_packed(tmp_path / "j" / jcompile.COMPILED_NAME))
    else:
        assert out == tmp_path / "t" / "dataset" and len(_files(out)) == 3 * (3 * 5 + 1)
        for rel in _files(tmp_path / "j"):
            assert (tmp_path / "t" / rel).read_bytes() == (tmp_path / "j" / rel).read_bytes()
