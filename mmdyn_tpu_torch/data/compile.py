"""Compiling simulator dumps into a corpus, and the corpus on disk (port of
``mmdyn_tpu/data/compile.py``; reference mmdyn/pytorch/utils/datasets.py:
159-312).

``compile_dataset`` reads ``<dataset>/dataset/**`` (``visual_*``,
``tactile_*``, ``seg_*`` PNGs and one ``data.json`` per sequence) and writes
the packed per-sequence arrays, uint8 frames already at the 64x64 training
resolution, in one of two formats:

* an ``.npz`` archive, loaded into host memory;
* a packed directory of one raw ``.npy`` per key, memmapped, so a large
  corpus streams from disk.

Either sits at ``<dataset>/compiled_dataset_v2.npz`` (``_nocrop`` for the
variant compiled without the seg-bbox re-crop). The compile is host work, as
in the JAX package: PIL, or the native C++ ingest library
(``data/native.py``). Pillow is imported when an image is read, so importing
this module needs none.

Reference behaviours kept, each gated by ``strict_parity``:

* the LAST sequence of the glob order is never emitted (the reference only
  flushes a sequence when the next one starts, datasets.py:210-224);
* the 'sv' dataset variant appends each sequence seq_length // 5 times
  (datasets.py:213-220, whose copy loop mutates nothing: plain duplication);
* quaternion min / max forced to [-1, 1] (datasets.py:203-204);
* min-max normalisation with NaN -> 0 for degenerate ranges
  (datasets.py:407-408);
* seg pixels equal to 1 zeroed after crop + resize (datasets.py:240);
* availability flags from the per-channel std of the 256x256 crops
  (datasets.py:247-249);
* sequences shuffled once at compile with ``default_rng(seed).permutation``
  (datasets.py:259-262).
"""

from __future__ import annotations

import json
import shutil
from collections import Counter
from pathlib import Path

import numpy as np

from mmdyn_tpu_torch.config import COMPILE_SIZE, IMAGE_SIZE

COMPILED_NAME = "compiled_dataset_v2.npz"
# the --no-crop variant: the same pipeline without the seg-bbox re-crop, under
# its own name so both variants can sit in one dataset directory
NOCROP_NAME = "compiled_dataset_v2_nocrop.npz"


def compiled_name_for(crop=True):
    return COMPILED_NAME if crop else NOCROP_NAME


def _minmax_normalize(x, lo, hi):
    """(x - lo) / (hi - lo), NaN -> 0 (datasets.py:407-408)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.nan_to_num((x - lo) / (hi - lo), nan=0.0)


def _bounding_box(img):
    """Square-expanded bbox of the max-valued seg region (datasets.py:347-366)."""
    mask = np.where(img == np.max(img))
    ymin, ymax = np.min(mask[0]), np.max(mask[0])
    xmin, xmax = np.min(mask[1]), np.max(mask[1])
    height = ymax - ymin
    width = xmax - xmin
    diff = height - width
    if diff > 0:
        xmin = max(0, xmin - diff / 2)
        xmax = min(img.shape[1], xmax + diff / 2)
    elif diff < 0:
        ymin = max(0, ymin - abs(diff) / 2)
        ymax = min(img.shape[0], ymax + abs(diff) / 2)
    return xmin, ymin, xmax, ymax


def _load_image(img_path, bounding_box=None, resize=True):
    """PIL load + crop + 256x256 resize + 3-channel cast (datasets.py:318-345)."""
    from PIL import Image

    img = Image.open(img_path)
    if bounding_box is not None:
        img = img.crop(bounding_box)
    if resize:
        img = img.resize((COMPILE_SIZE, COMPILE_SIZE))
    np_img = np.array(img).copy()
    if np_img.ndim == 2:
        np_img = np.repeat(np_img[:, :, np.newaxis], 3, axis=2).astype(np.uint8)
    img.close()
    return np_img


def _to_train_res(np_img):
    """256x256 -> 64x64 bilinear, the train-time torchvision Resize
    (datasets.py:23-26 uses PIL-backed bilinear)."""
    from PIL import Image

    img = Image.fromarray(np_img[:, :, :3])
    img = img.resize((IMAGE_SIZE, IMAGE_SIZE), Image.BILINEAR)
    return np.array(img, dtype=np.uint8)


def _check_uniform(dump_root, visual_images, tactile_images, seg_images, data_files):
    """Every sequence directory holds the same number of visual frames, as many
    tactile and seg frames, and one data.json. The reference derives
    seq_length as a global ratio (datasets.py:176) and silently misaligns
    frames otherwise: a partly written dump, a run killed between the streams
    of one frame, or two runs writing one directory."""
    def per_dir(paths):
        return Counter(p.parent for p in paths)

    counts = per_dir(visual_images)
    tac_counts, seg_counts = per_dir(tactile_images), per_dir(seg_images)
    data_dirs = {d.parent for d in data_files}
    uniform = len(set(counts.values())) <= 1
    if uniform and tac_counts == counts and seg_counts == counts and set(counts) == data_dirs:
        return
    hist = Counter(counts.values())
    mode = hist.most_common(1)[0][0] if hist else 0
    bad = sorted(str(d) for d, c in counts.items() if c != mode)[:8]
    ragged = sorted(str(d) for d in counts
                    if tac_counts.get(d, 0) != counts[d]
                    or seg_counts.get(d, 0) != counts[d])[:8]
    # dirs with frames but no data.json and dirs with data.json but no frames
    unpaired = sorted(str(d) for d in set(counts).symmetric_difference(data_dirs))[:8]
    raise ValueError(
        f"non-uniform dump under {dump_root}: visual frame counts "
        f"{dict(hist)} (expected every sequence to have {mode}); "
        f"offending dirs: {bad or ragged or unpaired} "
        f"(ragged tactile/seg streams: {ragged}; "
        f"frame/data.json mismatches: {unpaired}) — was the directory "
        "written by more than one run, or a run killed mid-sequence?")


def _native_engine(engine):
    """The native library module for ``engine`` ('native', or 'auto' when the
    library builds), else None for the PIL path."""
    if engine == "pil":
        return None
    from mmdyn_tpu_torch.data import native

    if native.available():
        return native
    if engine == "native":
        raise RuntimeError(f"native ingest library failed to build: {native.build_error()}")
    return None


def compile_dataset(dataset_path, strict_parity=True, seed=None,
                    compiled_name=COMPILED_NAME, verbose=True, engine="auto",
                    crop=True):
    """Compile ``<dataset_path>/dataset/**`` dumps into a packed corpus.

    ``engine``: 'pil' (the reference-exact Python path), 'native' (the C++
    ingest library: the same pipeline, OpenMP-parallel over frames, within 1
    of PIL on uint8; raises when the library does not build) or 'auto'
    (native when it builds, else PIL). ``crop=False`` skips the reference's
    seg-bbox re-crop on every stream, keeping the camera frame whole; write it
    under ``NOCROP_NAME``. A ``compiled_name`` ending in ``.npz`` writes an
    archive, any other a packed directory. Returns the written path.
    """
    root = Path(dataset_path).expanduser()
    dump_root = root / "dataset"
    tactile_images = sorted(dump_root.glob("**/tactile_*.png"))
    visual_images = sorted(dump_root.glob("**/visual_*.png"))
    seg_images = sorted(dump_root.glob("**/seg_*.png"))
    data_files = sorted(dump_root.glob("**/data.json"))
    if not data_files:
        raise AssertionError(f"no data.json under {dump_root}")
    _check_uniform(dump_root, visual_images, tactile_images, seg_images, data_files)
    seq_length = int(len(visual_images) / len(data_files))
    suffix = str(seq_length - 1).zfill(4)
    final_visual_images = sorted(dump_root.glob(f"**/visual_{suffix}.png"))
    final_tactile_images = sorted(dump_root.glob(f"**/tactile_{suffix}.png"))
    final_seg_images = sorted(dump_root.glob(f"**/seg_{suffix}.png"))

    if verbose:
        print(f"Visual images: {len(visual_images)}, Tactile images: "
              f"{len(tactile_images)}, Sequences: {len(data_files)}, "
              f"Sequence length: {seq_length}")

    # pose / shock min-max over the whole corpus (datasets.py:187-204)
    infos, pose_list, shock_list = [], [], []
    for d in data_files:
        with open(d) as f:
            info = json.load(f)
        infos.append(info)
        pose_list.append(np.concatenate(
            (np.asarray(info["position"]), np.asarray(info["orientation"])), axis=1))
        if "shock" in info:
            shock_list.append(np.asarray(info["shock"], dtype=np.float64).reshape(
                len(info["shock"]), -1))
        else:
            shock_list.append(np.zeros((1, 1)))
    pose_all = np.concatenate(pose_list, axis=0)
    shock_all = np.concatenate(shock_list, axis=0)
    pose_min, pose_max = pose_all.min(axis=0), pose_all.max(axis=0)
    shock_min, shock_max = shock_all.min(axis=0), shock_all.max(axis=0)
    pose_min[3:] = -1.0
    pose_max[3:] = 1.0
    has_shock = any("shock" in info for info in infos)
    if has_shock and not all("shock" in info for info in infos):
        missing = [str(data_files[i]) for i, info in enumerate(infos)
                   if "shock" not in info][:5]
        raise ValueError(
            "mixed corpus: some sequences have 'shock' and some do not "
            f"(e.g. {missing}); compile shock and no-shock experiments into "
            "separate datasets")
    shock_dim = shock_all.shape[1]

    sv = "sv" in str(dataset_path)
    native = _native_engine(engine)
    n_emit = len(data_files) - 1 if strict_parity else len(data_files)

    def compile_sequence_pil(frame_slice):
        vis, tac, seg, avail = [], [], [], []
        for vis_p, tac_p, seg_p in zip(visual_images[frame_slice],
                                       tactile_images[frame_slice],
                                       seg_images[frame_slice]):
            bbox = _bounding_box(_load_image(seg_p, resize=False)) if crop else None
            seg_np = _load_image(seg_p, bounding_box=bbox)
            seg_np = np.where(seg_np == 1, 0, seg_np)
            visual_np = _load_image(vis_p, bounding_box=bbox)
            tactile_np = _load_image(tac_p, bounding_box=bbox)
            avail.append(np.array([
                float(np.std(visual_np, axis=(0, 1)).any()),
                float(np.std(tactile_np, axis=(0, 1)).any())], np.float32))
            vis.append(_to_train_res(visual_np))
            tac.append(_to_train_res(tactile_np))
            seg.append(_to_train_res(seg_np.astype(np.uint8)))
        return np.stack(vis), np.stack(tac), np.stack(seg), np.stack(avail)

    def compile_final_pil(s):
        bbox = (_bounding_box(_load_image(final_seg_images[s], resize=False))
                if crop else None)
        return (_to_train_res(_load_image(final_visual_images[s], bounding_box=bbox)),
                _to_train_res(_load_image(final_tactile_images[s], bounding_box=bbox)))

    keys = ("visual", "tactile", "seg", "avail", "pose", "shock",
            "final_visual", "final_tactile", "final_pose")
    seqs = {k: [] for k in keys}
    for s in range(n_emit):
        info = infos[s]
        frame_slice = slice(s * seq_length, (s + 1) * seq_length)
        if native is not None:
            vis64, tac64, seg64, avail = native.compile_frames(
                seg_images[frame_slice], visual_images[frame_slice],
                tactile_images[frame_slice], crop=crop)
            fvis, ftac = native.compile_final(
                final_seg_images[s], final_visual_images[s],
                final_tactile_images[s], crop=crop)
        else:
            vis64, tac64, seg64, avail = compile_sequence_pil(frame_slice)
            fvis, ftac = compile_final_pil(s)

        pose = np.concatenate((np.asarray(info["position"]),
                               np.asarray(info["orientation"])), axis=1)
        pose = _minmax_normalize(pose, pose_min, pose_max).astype(np.float32)
        final_pose = _minmax_normalize(
            np.concatenate((info["position"][-1], info["orientation"][-1])),
            pose_min, pose_max).astype(np.float32)
        if has_shock:
            shock = np.asarray(info["shock"], dtype=np.float64).reshape(seq_length, -1)
            shock = _minmax_normalize(shock, shock_min, shock_max).astype(np.float32)
        else:
            shock = np.zeros((seq_length, shock_dim), np.float32)

        row = dict(zip(keys, (vis64, tac64, seg64, avail, pose, shock,
                              fvis, ftac, final_pose)))
        for _ in range((seq_length // 5) if sv else 1):   # datasets.py:213-220
            for k in keys:
                seqs[k].append(row[k])

    n = len(seqs["visual"])
    if verbose:
        print(f"Compiled {n} sequences"
              + (" (last sequence dropped — reference parity)" if strict_parity else ""))

    order = np.random.default_rng(seed).permutation(n)   # datasets.py:259-262
    shuffled = lambda k: np.stack([seqs[k][j] for j in order])  # noqa: E731
    packed = {k: shuffled(k) for k in keys if k != "shock"}
    packed.update({
        "seq_length": np.int64(seq_length),
        "has_shock": np.bool_(has_shock),
        "crop": np.bool_(crop),
        # the normalisation constants, which the reference computes and drops:
        # serving denormalises pose and shock with them
        "pose_min": pose_min.astype(np.float32),
        "pose_max": pose_max.astype(np.float32),
    })
    if has_shock:
        packed["shock"] = shuffled("shock")
        packed["shock_min"] = shock_min.astype(np.float32)
        packed["shock_max"] = shock_max.astype(np.float32)

    out = root / compiled_name
    if str(compiled_name).endswith(".npz"):
        np.savez_compressed(out, **packed)
    else:
        save_packed_dir(out, packed)
    return out


def save_packed_dir(out_dir, packed):
    """Write ``packed`` as one raw ``.npy`` per key. Writes a temporary
    sibling and renames it over the target, so an interrupted write never
    leaves a partial corpus and a rewrite never leaves stale keys."""
    out_dir = Path(out_dir)
    tmp_dir = out_dir.with_name(out_dir.name + ".tmp")
    if tmp_dir.exists():
        shutil.rmtree(tmp_dir)
    tmp_dir.mkdir(parents=True)
    for k, v in packed.items():
        np.save(tmp_dir / f"{k}.npy", np.asarray(v))
    if out_dir.exists():
        shutil.rmtree(out_dir)
    tmp_dir.rename(out_dir)
    return out_dir


def load_packed(path, mmap=True):
    """A compiled corpus as a dict of arrays: an ``.npz`` file (in memory) or
    a packed directory (memmapped when ``mmap``)."""
    path = Path(path)
    if path.is_dir():
        return {f.stem: np.load(f, mmap_mode="r" if mmap else None)
                for f in sorted(path.glob("*.npy"))}
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _color_mask(img_path, crop_size):
    """HSV-threshold object mask for real STS captures (datasets.py:368-377)."""
    import cv2

    x, y, w, h = crop_size
    img = cv2.imread(str(img_path))[y:y + h, x:x + w]
    hsv = cv2.cvtColor(img, cv2.COLOR_BGR2HSV)
    lower = np.array([0, 50, 50])
    upper = np.array([150, 255, 255])
    return cv2.bitwise_not(cv2.inRange(hsv, lower, upper))


def _load_real_image(img_path, mask=None, crop_size=None):
    """Real-capture load: optional colour mask + grey fill, 256 resize
    (datasets.py:318-345, the real branch)."""
    import cv2
    from PIL import Image

    if mask is None:
        img = Image.open(img_path)
    else:
        if crop_size is None:
            raise ValueError("a colour mask needs the crop it was taken in")
        x, y, w, h = crop_size
        img = cv2.imread(str(img_path))[y:y + h, x:x + w]
        img = cv2.bitwise_and(img, img, mask=mask)
        img[mask == 0] = [210] * 3
        img = Image.fromarray(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
    img = img.resize((COMPILE_SIZE, COMPILE_SIZE))
    np_img = np.array(img).copy()
    if np_img.ndim == 2:
        np_img = np.repeat(np_img[:, :, np.newaxis], 3, axis=2).astype(np.uint8)
    img.close()
    return np_img


def compile_real_dataset(dataset_path, seed=None, compiled_name=COMPILED_NAME,
                         verbose=True, crop_size=(40, 10, 330, 290)):
    """Compile real sensor captures (datasets.py:269-312): per trial, the
    visual and tactile initial and final images, the final ones masked by
    colour. The reference stores single-frame sequences (datasets.py:301-302)
    and its sequence length of 2 counts the initial and final frame."""
    root = Path(dataset_path).expanduser()
    dump_root = root / "dataset"
    initial_visual = sorted(dump_root.glob("**/visual/initial.png"))
    initial_tactile = sorted(dump_root.glob("**/tactile/initial.png"))
    final_visual = sorted(dump_root.glob("**/visual/final.png"))
    final_tactile = sorted(dump_root.glob("**/tactile/final.png"))
    if not initial_visual:
        raise AssertionError(f"no real captures under {dump_root}")
    seq_length = 2

    if verbose:
        print(f"Visual images: {len(initial_visual) * seq_length}, Tactile "
              f"images: {len(initial_tactile) * seq_length}, Sequences: "
              f"{len(initial_visual)}, Sequence length: {seq_length}")

    vis_seqs, tac_seqs, fv_list, ft_list = [], [], [], []
    for i in range(len(initial_visual)):
        mask = _color_mask(final_visual[i], crop_size)
        vis_seqs.append(_to_train_res(_load_real_image(initial_visual[i]))[None])
        tac_seqs.append(_to_train_res(_load_real_image(initial_tactile[i]))[None])
        fv_list.append(_to_train_res(_load_real_image(final_visual[i], mask=mask,
                                                      crop_size=crop_size)))
        ft_list.append(_to_train_res(_load_real_image(final_tactile[i], mask=mask,
                                                      crop_size=crop_size)))

    n = len(vis_seqs)
    order = np.random.default_rng(seed).permutation(n)
    t = vis_seqs[0].shape[0]
    packed = {
        "visual": np.stack([vis_seqs[j] for j in order]),
        "tactile": np.stack([tac_seqs[j] for j in order]),
        "pose": np.zeros((n, t, 7), np.float32),
        "avail": np.ones((n, t, 2), np.float32),
        "seg": np.full((n, t, IMAGE_SIZE, IMAGE_SIZE, 3), 255, np.uint8),
        "final_visual": np.stack([fv_list[j] for j in order]),
        "final_tactile": np.stack([ft_list[j] for j in order]),
        "final_pose": np.zeros((n, 7), np.float32),
        "seq_length": np.int64(t),
        "has_shock": np.bool_(False),
    }
    out = root / compiled_name
    np.savez_compressed(out, **packed)
    if verbose:
        print(f"Compiled {n} real sequences")
    return out
