"""Command line of the PyTorch port: the reference's flag surface
(veryfasttree_tpu.cli) on a CUDA device.

    python -m veryfasttree_tpu_torch -nt -noml -nosupport alignment.fasta

A missing GPU raises; the flags of parts not ported yet raise
NotImplementedError (see pipeline.py).
"""
from __future__ import annotations

import sys

from veryfasttree_tpu.cli import args_to_options, basic_help, build_parser
from veryfasttree_tpu.io.alignment import open_maybe_compressed
from veryfasttree_tpu.utils.progress import TeeStream

from .pipeline import run_pipeline
from .utils.device import resolve_device


def main(argv=None) -> int:
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.expert:
        parser.print_help()
        return 0
    if ns.help_:
        print(basic_help())
        return 0
    device = resolve_device("cuda")
    opts = args_to_options(ns)

    log_file = open(opts.log_file_name, "w") if opts.log_file_name else None
    log = TeeStream(log_file, sys.stderr) if log_file else sys.stderr
    try:
        opts.derive_settings(log)
        in_fp = open_maybe_compressed(opts.in_file_name) if opts.in_file_name \
            else sys.stdin
        out_fp = open(opts.out_file_name, "w") if opts.out_file_name \
            else sys.stdout
        try:
            run_pipeline(opts, in_fp, out_fp, log_fp=log, device=device)
        finally:
            if opts.out_file_name:
                out_fp.close()
            if opts.in_file_name:
                in_fp.close()
    except Exception as e:  # noqa: BLE001  (mirror reference main.cpp:673-678)
        print(f"ERROR: {e}", file=sys.stderr)
        if ns.verbose > 1:
            raise
        return 1
    finally:
        if log_file:
            log_file.close()
    return 0
