"""Command-line entry point of the PyTorch port.

    python -m colormipsearch_tpu_torch.cli.main colorDepthSearch \\
        -m masks.json -i targets.json --device cuda ...
    python -m colormipsearch_tpu_torch.cli.main gradientScores \\
        --matches results/masks --device cuda ...

``colorDepthSearch`` and ``gradientScores`` are ported; the flags and
the FS (JSON) result files are those of the JAX package's commands.
"""

from __future__ import annotations

import argparse
import logging
import sys

from colormipsearch_tpu_torch.cli import commands, common


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="colormipsearch-tpu-torch",
        description="color depth MIP search on PyTorch/CUDA",
        # JCommander-style @argfile expansion (one argument per line)
        fromfile_prefix_chars="@")
    p.add_argument("--cacheSize", type=int, default=0,
                   help="target image cache size (images)")
    p.add_argument("--cdsConcurrency", type=int, default=0,
                   help="host-side decode concurrency (0 = auto)")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="command", required=True)
    sp = sub.add_parser(
        "colorDepthSearch",
        help="all-pairs color depth search (pixel-match pass)")
    commands.configure_color_depth_search(sp)
    common.ensure_common_args(sp)
    sp.set_defaults(func=commands.cmd_color_depth_search)
    sp = sub.add_parser(
        "gradientScores",
        help="shape (gradient-area-gap) rescoring of CDS matches")
    commands.configure_gradient_scores(sp)
    common.ensure_common_args(sp)
    sp.set_defaults(func=commands.cmd_gradient_scores)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.DEBUG if args.verbose else logging.INFO,
        format="%(asctime)s %(levelname).1s %(name)s %(message)s")
    if args.cacheSize > 0:
        from colormipsearch_tpu_torch.io.cache import initialize_cache

        initialize_cache(args.cacheSize)
    try:
        return args.func(args) or 0
    except (FileNotFoundError, NotADirectoryError) as e:
        print(f"{args.command}: file not found: {e}", file=sys.stderr)
        if args.verbose:
            raise
        return 2
    except ValueError as e:
        print(f"{args.command}: {e}", file=sys.stderr)
        if args.verbose:
            raise
        return 2


if __name__ == "__main__":
    sys.exit(main())
