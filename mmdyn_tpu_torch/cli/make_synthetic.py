"""Write a synthetic dataset: simulator-dump-shaped PNGs, or a compiled
corpus directly (port of ``mmdyn_tpu/cli/make_synthetic.py``, same flags).

    python -m mmdyn_tpu_torch.cli.make_synthetic --out /tmp/ds --n-sequences 8
    python -m mmdyn_tpu_torch.cli.make_synthetic --out /tmp/ds --packed

The dumps need Pillow; ``--packed`` needs none. The training CLI compiles a
dump directory into a corpus when it finds none.
"""

import argparse


def build_parser():
    parser = argparse.ArgumentParser(description="Synthetic dataset")
    parser.add_argument("--out", required=True, type=str)
    parser.add_argument("--n-sequences", type=int, default=8)
    parser.add_argument("--seq-length", type=int, default=10)
    parser.add_argument("--with-shock", action="store_true", default=False)
    parser.add_argument("--packed", action="store_true", default=False,
                        help="Write the compiled npz directly (skip PNGs)")
    parser.add_argument("--seed", type=int, default=0)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)

    from pathlib import Path

    from mmdyn_tpu_torch.data.compile import COMPILED_NAME
    from mmdyn_tpu_torch.data.synthetic import make_compiled_arrays, make_synthetic_dumps

    if args.packed:
        out = make_compiled_arrays(Path(args.out) / COMPILED_NAME,
                                   n_sequences=args.n_sequences,
                                   seq_length=args.seq_length,
                                   with_shock=args.with_shock, seed=args.seed)
    else:
        out = make_synthetic_dumps(args.out, n_sequences=args.n_sequences,
                                   seq_length=args.seq_length,
                                   with_shock=args.with_shock, seed=args.seed)
    print(f"wrote {out}")
    return out


if __name__ == "__main__":
    main()
