"""Batch re-render the tactile stream of an existing dump on the device (port
of ``tools/rerender_dataset.py``).

Reads every ``depth_*.png`` under ``<root>/dataset/**``, reconstructs the
clipped depth buffers, and renders the corresponding tactile images in
batches (``sim/tactile_torch.py``): to regenerate a corpus's tactile stream
without re-running physics, or to time the device's shading against the
host pipeline (the reference shades per frame in NumPy,
tact_sim/tactile/shader.py:78-129).

    python -m mmdyn_tpu_torch.tools.rerender_dataset --dataset data_runs/exp1 \
        [--suffix ""] [--thickness 0.005] [--batch 128] [--platform cpu]

Assumes the dump came from a static sensor with the exp CLIs' camera
geometry (the sensor pose is not stored in the dumps; pass --size /
--position to match another run). Depth PNGs quantise the buffer to uint8,
so re-rendered images can differ from the originals by a few counts: exact
parity is the job of --device-render at generation time, not of this tool.
As in the JAX package's tool, the renderer takes the exp CLIs' light
intensities (``TactileRendererTorch.from_sensor``: 2.0 and 2.0) whatever
--i-diffuse / --i-specular say.

Prints one JSON line: frames, seconds and frames/s, and the split of the
seconds into ``host_read_s`` (PNG reads), ``render_s`` (the depth upload and
the render; on the card the device time between CUDA events) and ``write_s``
(the uint8 frames' download and the PNG writes). Needs cv2.
"""

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np


def build_parser():
    ap = argparse.ArgumentParser(description="Re-render a dump's tactile stream")
    ap.add_argument("--dataset", required=True,
                    help="dump root (containing dataset/**/depth_*.png)")
    ap.add_argument("--suffix", default="",
                    help="output name suffix: tactile{suffix}_NNNN.png "
                         "(empty = overwrite the tactile stream). A non-empty "
                         "suffix is forced to start with '-' so the output "
                         "never matches the dataset compiler's tactile_*.png "
                         "glob (a '_re' suffix would corrupt frame counts)")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=float, nargs=3, default=[1.5, 1.5, 1.0])
    ap.add_argument("--position", type=float, nargs=3, default=[0, 0, 0.5])
    ap.add_argument("--thickness", type=float, default=0.005)
    ap.add_argument("--i-diffuse", type=float, default=2.0)
    ap.add_argument("--i-specular", type=float, default=2.0)
    ap.add_argument("--platform", default=None,
                    help="'cpu' renders on the CPU; otherwise the CUDA card")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    import torch

    from mmdyn_tpu_torch.utils.device import device_for_platform

    device = device_for_platform(args.platform)
    import cv2

    from mmdyn_tpu_torch.sim.physics import AnalyticBackend
    from mmdyn_tpu_torch.sim.sensor import make_sensor
    from mmdyn_tpu_torch.sim.tactile_torch import TactileRendererTorch

    backend = AnalyticBackend()
    sensor = make_sensor(backend, size=list(args.size),
                         position=list(args.position), sensor_vector=[0, 0, 1],
                         thickness=args.thickness)
    sensor.get_sensor_image()   # sets the view matrix
    sensor._set_lights(i_specular=args.i_specular, i_diffuse=args.i_diffuse)
    renderer = TactileRendererTorch.from_sensor(sensor, device=device)

    if args.suffix and not args.suffix.startswith("-"):
        args.suffix = "-" + args.suffix.lstrip("_")
    root = Path(args.dataset).expanduser() / "dataset"
    depths = sorted(root.glob("**/depth_*.png"))
    if not depths:
        sys.exit(f"no depth_*.png under {root}")

    cuda = device.type == "cuda"
    n, read_s, render_s, write_s = 0, 0.0, 0.0, 0.0
    t0 = time.perf_counter()
    for i in range(0, len(depths), args.batch):
        group = depths[i:i + args.batch]
        t = time.perf_counter()
        # save_image wrote (buffer * 255).astype(uint8); invert the quantise
        batch = np.stack([
            cv2.imread(str(p), cv2.IMREAD_GRAYSCALE).astype(np.float32) / 255.0
            for p in group])
        read_s += time.perf_counter() - t
        if cuda:
            start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            start.record()
            imgs = renderer(batch)
            end.record()
        else:
            t = time.perf_counter()
            imgs = renderer(batch)
            render_s += time.perf_counter() - t
        t = time.perf_counter()
        imgs = imgs.cpu().numpy()              # the download syncs
        if cuda:
            render_s += start.elapsed_time(end) / 1e3
        for img, p in zip(imgs, group):
            out = p.with_name(p.name.replace(
                "depth_", f"tactile{args.suffix}_"))
            cv2.imwrite(str(out), cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
            n += 1
        write_s += time.perf_counter() - t
    dt = time.perf_counter() - t0
    report = {"frames": n, "seconds": round(dt, 2),
              "frames_per_sec": round(n / dt, 1),
              "host_read_s": round(read_s, 3), "render_s": round(render_s, 3),
              "write_s": round(write_s, 3)}
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
