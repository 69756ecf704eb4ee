"""Command-line entry point of the PyTorch port.

    python -m colormipsearch_tpu_torch.cli.main colorDepthSearch \\
        -m masks.json -i targets.json --device cuda ...
    python -m colormipsearch_tpu_torch.cli.main gradientScores \\
        --matches results/masks --device cuda ...

The subcommands, flags and FS (JSON) result files are those of the JAX
package's CLI; the commands that run the device also take ``--device
{cuda,cpu}`` (cuda by default).
"""

from __future__ import annotations

import argparse
import logging
import sys

from colormipsearch_tpu_torch.cli import (
    commands,
    commands_admin,
    commands_export,
    commands_v2,
    common,
)


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

    def add(name, fn, configure, help=None, aliases=()):
        sp = sub.add_parser(name, help=help, aliases=list(aliases))
        configure(sp)
        # every reference command delegates to one CommonArgs
        # (cmd/AbstractCmdArgs.java:15-17); guarantee the same surface
        common.ensure_common_args(sp)
        sp.set_defaults(func=fn)
        return sp

    # ---- v3 commands (cmd/Main.java:25-36) ----
    add("colorDepthSearch", commands.cmd_color_depth_search,
        commands.configure_color_depth_search,
        help="all-pairs color depth search (pixel-match pass)")
    add("gradientScores", commands.cmd_gradient_scores,
        commands.configure_gradient_scores,
        help="gradient/shape rescoring of existing matches")
    add("normalizeGradientScores", commands.cmd_normalize_scores,
        commands.configure_normalize_scores,
        # the reference registers the typo'd name (cmd/Main.java:29) and
        # its README run-book still calls the pre-v3 "normalizeScores"
        aliases=["mormalizeGradientScores", "normalizeScores"],
        help="re-normalize gradient scores per mask")
    add("createColorDepthSearchDataInput", commands.cmd_create_data_input,
        commands.configure_create_data_input,
        help="create neuron metadata input from a library of images")
    add("exportData", commands_export.cmd_export_data,
        commands_export.configure_export_data,
        help="export matches/MIPs to the NeuronBridge publish schema")
    add("importPPPResults", commands_export.cmd_import_ppp,
        commands_export.configure_import_ppp,
        help="import raw PatchPerPix cov_scores results")
    add("tag", commands_export.cmd_tag, commands_export.configure_tag,
        help="bulk-tag neuron metadata")

    # ---- v2 commands (cmd_v2/Main.java:26-52) ----
    add("searchFromJSON", commands.cmd_search_from_json,
        commands.configure_search_from_json,
        help="v2 search using JSON MIP lists")
    add("searchLocalFiles", commands.cmd_search_local_files,
        commands.configure_search_local_files,
        help="v2 search over local image files/zips")
    add("gradientScore", commands_v2.cmd_gradient_score_v2,
        commands_v2.configure_gradient_score_v2,
        help="v2 shape rescoring of result files")
    add("gradientScoresFromMatchedResults", commands_v2.cmd_reverse_transfer,
        commands_v2.configure_reverse_transfer,
        help="transfer negative scores from reverse search results")
    add("mergeResults", commands.cmd_merge_results,
        commands.configure_merge_results,
        help="merge per-mask result files across libraries")
    add("createColorDepthSearchJSONInput",
        commands_v2.cmd_create_json_input_v2,
        commands_v2.configure_create_json_input_v2,
        help="v2 MIP list creation from local images")
    add("convertPPPResults", commands_admin.cmd_convert_ppp,
        commands_admin.configure_convert_ppp,
        help="raw PPP results to per-EM v2 JSON")
    add("copyPPPMatches", commands_admin.cmd_copy_ppp,
        commands_admin.configure_copy_ppp,
        help="copy/trim PPP match files")
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
