# build_parser, basic_help and args_to_options copy veryfasttree_tpu/cli.py (the port imports none of it).
"""Command line of the PyTorch port: the reference's flag surface on a CUDA
device.

    python -m veryfasttree_tpu_torch -nt alignment.fasta
    python -m veryfasttree_tpu_torch -nt -noml -nosupport alignment.fasta

Multi-GPU (parallel/): one process drives one card.  -mesh-sp n (and
-mesh-dp m) without -coordinator starts n x m rank processes on this
host, rank i on cuda:i (launch_local); across hosts, run one process per
card with -coordinator host:port -n-hosts K -host-id I (VFT_LOCAL_RANK
names its card where I is not).  Only rank 0 writes the tree and the log.

A missing GPU raises; under a mesh the parts not ported yet raise
NotImplementedError (pipeline.unported_under_mesh).
"""
from __future__ import annotations

import argparse
import io
import os
import socket
import subprocess
import sys
import time

import torch

from . import constants
from .io.alignment import open_maybe_compressed
from .options import Options
from .parallel import multihost
from .parallel.mesh import requested_ranks
from .pipeline import run_pipeline
from .utils.device import resolve_device
from .utils.progress import TeeStream


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m veryfasttree_tpu_torch", allow_abbrev=False, add_help=False,
        description=f"{constants.NAME} {constants.VERSION} on PyTorch/CUDA -- "
                    "approximately-maximum-likelihood phylogenetic trees "
                    f"(FastTree-2 / VeryFastTree {constants.COMPAT_VERSION} "
                    "compatible)")
    a = p.add_argument
    a("alignment_file", nargs="?", default="", help="alignment (FASTA/FASTQ/"
      "PHYLIP/NEXUS; - or absent = stdin; .gz/.bz2/.xz ok)")
    a("-h", "--help", action="store_true", dest="help_")
    a("-expert", action="store_true")
    # io
    a("-out", default="", metavar="file")
    a("-n", type=int, default=1, metavar="n", help="number of alignments")
    a("-verbose", type=int, default=1, metavar="lvl")
    a("-quiet", action="store_true")
    a("-nopr", action="store_true")
    a("-log", default="", metavar="logfile")
    a("-quote", action="store_true")
    a("-intree", default="", metavar="newick_file")
    a("-intree1", default="", metavar="newick_file")
    # distances
    a("-nt", action="store_true", help="nucleotide alignment")
    a("-makematrix", action="store_true")
    a("-rawdist", action="store_true")
    a("-logdist", action="store_true", help="(obsolete; on by default)")
    a("-pseudo", nargs="?", const=1.0, type=float, default=None, metavar="weight")
    a("-matrix", default="", metavar="prefix")
    a("-nomatrix", action="store_true")
    # topology refinement
    a("-nni", type=int, default=-1, metavar="n")
    a("-spr", type=int, default=2, metavar="n")
    a("-noml", action="store_true")
    a("-nome", action="store_true")
    a("-sprlength", type=int, default=10, metavar="n")
    a("-mlnni", type=int, default=-1, metavar="n")
    a("-mlacc", type=int, default=1, metavar="n")
    a("-mllen", action="store_true")
    a("-slownni", action="store_true")
    a("-approxml", "-mlapprox", action="store_true", dest="approxml",
      help="approximate posterior distributions for amino acids")
    a("-mlexact", action="store_true", help="(obsolete; on by default)")
    a("-exactml", action="store_true", help="(obsolete; on by default)")
    # models
    a("-gtr", action="store_true")
    a("-gtrrates", nargs=6, type=float, default=None,
      metavar=("ac", "ag", "at", "cg", "ct", "gt"))
    a("-gtrfreq", nargs=4, type=float, default=None, metavar=("A", "C", "G", "T"))
    a("-wag", action="store_true")
    a("-lg", action="store_true")
    a("-trans", default="", metavar="file")
    a("-cat", type=int, default=constants.N_DEFAULT_RATE_CATS, metavar="n")
    a("-nocat", action="store_true")
    a("-gamma", action="store_true")
    # support
    a("-nosupport", action="store_true")
    a("-boot", type=int, default=1000, metavar="n")
    a("-noboot", action="store_true")
    a("-seed", type=int, default=None, metavar="n")
    # search
    a("-slow", action="store_true")
    a("-fastest", action="store_true")
    a("-2nd", action="store_true", dest="second")
    a("-no2nd", action="store_true")
    a("-top", action="store_true")
    a("-notop", action="store_true")
    a("-topm", type=float, default=1.0, metavar="m")
    a("-close", type=float, default=-1.0, metavar="close")
    a("-refresh", type=float, default=0.8, metavar="refresh")
    a("-nj", action="store_true", dest="plain_nj")
    a("-bionj", action="store_true")
    # constraints
    a("-constraints", default="", metavar="file")
    a("-constraintWeight", type=float, default=100.0, metavar="w")
    # optimization / compatibility knobs
    a("-threads", type=int, default=None, metavar="n")
    a("-threads-verbose", action="store_true")
    a("-threads-mode", type=int, default=1, metavar="mode")
    a("-threads-level", type=int, default=3, metavar="lvl")
    a("-threads-ptw", type=int, default=50, metavar="n")
    a("-double-precision", action="store_true")
    a("-ext", default="AUTO", metavar="name",
      help="(compat; TPU build always uses the XLA path)")
    a("-fastexp", type=int, default=0, metavar="lvl")
    a("-disk-computing", action="store_true")
    a("-disk-computing-path", default="", metavar="path")
    a("-disk-dynamic-computing", action="store_true")
    a("-disk-dynamic-limit", type=int, default=-1, metavar="n")
    a("-relative-progress", action="store_true")
    # TPU-native knobs
    a("-mesh-sp", type=int, default=None, metavar="n",
      help="devices along the alignment-position axis (default: all)")
    a("-mesh-dp", type=int, default=1, metavar="n",
      help="devices along the candidate/data axis")
    a("-coordinator", default="", metavar="host:port",
      help="multi-host: jax.distributed coordinator address (run the same "
           "command on every host with matching -n-hosts and its -host-id)")
    a("-n-hosts", type=int, default=0, metavar="k",
      help="multi-host: number of participating processes")
    a("-host-id", type=int, default=None, metavar="i",
      help="multi-host: this process's id (0..k-1; 0 writes the output)")
    a("-two-tier-min", type=int, default=20000, metavar="n",
      help="store leaves as int8 codes only (16x HBM cut) at >= n unique "
           "sequences; 0 forces two-tier, -1 disables it")
    a("-checkpoint", default="", metavar="file", dest="checkpoint",
      help="array-state checkpoint file: saved after every ML-NNI round; "
           "if present at startup the run resumes from it")
    return p


def basic_help() -> str:
    """Curated common-options help (ref main.cpp:538-599 basicCli): usage
    examples plus the ~20 flags most users need; the full surface is behind
    -expert (ref main.cpp:623-627)."""
    name = "python -m veryfasttree_tpu_torch"
    lines = [
        f"{constants.NAME} {constants.VERSION} (PyTorch/CUDA)",
        f"  {name} protein_alignment > tree",
        f"  {name} < protein_alignment > tree",
        f"  {name} -out tree protein_alignment",
        f"  {name} -nt nucleotide_alignment > tree",
        f"  {name} -nt -gtr < nucleotide_alignment > tree",
        f"  {name} accepts alignments in NEXUS, Fasta, Fastq or Phylip "
        "interleaved formats, optionally compressed with gzip, bzip2 or xz.",
        "",
        "Common options:",
    ]
    common = [
        ("-n <number>", "to analyze multiple alignments (phylip format only) "
         "(use for global bootstrap, with seqboot and CompareToBootstrap.pl)"),
        ("-intree newick_file", "to set the starting tree(s)"),
        ("-intree1 newick_file", "to use this starting tree for all the "
         "alignments (for faster global bootstrap on huge alignments)"),
        ("-quiet", "to suppress reporting information"),
        ("-nopr", "to suppress progress indicator"),
        ("-log logfile", "save intermediate trees, settings, and model details"),
        ("-quote", "allow spaces and other restricted characters (but not ') "
         "in sequence names and quote names in the output tree"),
        ("-pseudo", "to use pseudocounts (recommended for highly gapped "
         "sequences)"),
        ("-fastest", "speed up the neighbor joining phase & reduce memory "
         "usage (recommended for >50,000 sequences)"),
        ("-nosupport", "to not compute support values"),
        ("-gtr", "generalized time-reversible model (nucleotide alignments "
         "only)"),
        ("-lg", "Le-Gascuel 2008 model (amino acid alignments only)"),
        ("-wag", "Whelan-And-Goldman 2001 model (amino acid alignments only)"),
        ("-noml", "to turn off maximum-likelihood"),
        ("-nome", "to turn off minimum-evolution NNIs and SPRs (recommended "
         "if running additional ML NNIs with -intree); -nome -mllen with "
         "-intree to optimize branch lengths for a fixed topology"),
        ("-cat n", "to specify the number of rate categories of sites "
         "(default 20) or -nocat to use constant rates"),
        ("-gamma", "after optimizing the tree under the CAT approximation, "
         "rescale the lengths to optimize the Gamma20 likelihood"),
        ("-constraints constraintAlignment", "to constrain the topology "
         "search; constraintAlignment should have 1s or 0s to indicate "
         "splits"),
        ("-double-precision", "use double precision arithmetic"),
        ("-expert", "see more options"),
    ]
    import textwrap
    for flag, desc in common:
        lines.append(f"  {flag}")
        lines.extend(textwrap.wrap(desc, width=74, initial_indent="      ",
                                   subsequent_indent="      "))
    lines.append("")
    lines.append("For more information, see "
                 "https://github.com/citiususc/veryfasttree or docs/.")
    return "\n".join(lines)


def args_to_options(ns) -> Options:
    opts = Options()
    opts.n_codes = 4 if ns.nt else 20
    opts.n_align = ns.n
    opts.verbose = 0 if ns.quiet else ns.verbose
    opts.show_progress = not (ns.quiet or ns.nopr)
    opts.log_file_name = ns.log
    opts.quote = ns.quote
    opts.out_file_name = ns.out
    opts.in_file_name = "" if ns.alignment_file in ("", "-") else ns.alignment_file
    if ns.intree:
        opts.intree_file = ns.intree
    if ns.intree1:
        opts.intree_file = ns.intree1
        opts.intree1 = True
    opts.make_matrix = ns.makematrix
    if ns.rawdist:
        opts.logdist = False
    if ns.pseudo is not None:
        opts.pseudo_weight = ns.pseudo
    opts.matrix_prefix = ns.matrix
    if ns.nomatrix:
        opts.use_matrix = False
    opts.nni = ns.nni
    opts.spr = ns.spr
    if ns.noml:
        opts.ml_nni = 0
    if ns.nome:
        opts.nni = 0
        opts.spr = 0
    opts.max_spr_length = ns.sprlength
    if ns.mlnni != -1:
        opts.ml_nni = ns.mlnni
    opts.ml_accuracy = ns.mlacc
    opts.ml_len = ns.mllen
    if ns.slownni:
        opts.fast_nni = False
    if ns.approxml:
        opts.exact_ml = False
    opts.use_gtr = ns.gtr
    if ns.gtrrates is not None:
        opts.use_gtr = True
        opts.use_gtr_rates = True
        opts.gtr_rates = tuple(ns.gtrrates)
    if ns.gtrfreq is not None:
        opts.use_gtr = True
        opts.use_gtr_freq = True
        tot = sum(ns.gtrfreq)
        if abs(tot - 1.0) > 0.01:
            raise ValueError("-gtrfreq values do not sum to 1")
        opts.gtr_freq = tuple(f / tot for f in ns.gtrfreq)
    opts.use_wag = ns.wag
    opts.use_lg = ns.lg
    opts.transition_file = ns.trans
    opts.n_rate_cats = 1 if ns.nocat else ns.cat
    opts.gamma_loglk = ns.gamma
    opts.n_bootstrap = 0 if (ns.nosupport or ns.noboot) else ns.boot
    if ns.seed is not None:
        opts.seed = ns.seed
    opts.slow = ns.slow
    opts.fastest = ns.fastest
    if ns.fastest:
        opts.tophits_refresh = 0.5
        opts.use_tophits_2nd = True
    if ns.second:
        opts.use_tophits_2nd = True
    if ns.no2nd:
        opts.use_tophits_2nd = False
    if ns.notop:
        opts.tophits_mult = 0.0
    if ns.topm != 1.0:
        opts.tophits_mult = ns.topm
    opts.tophits_close = ns.close
    opts.tophits_refresh = ns.refresh if ns.refresh != 0.8 else opts.tophits_refresh
    if ns.bionj:
        opts.bionj = True
    if ns.plain_nj:
        opts.bionj = False
    opts.constraints_file = ns.constraints
    opts.constraint_weight = ns.constraintWeight
    _threads = getattr(ns, "threads")
    opts.threads_explicit = _threads is not None
    opts.threads = _threads if _threads is not None else \
        int(os.environ.get("OMP_NUM_THREADS", "1") or 1)
    opts.threads_verbose = getattr(ns, "threads_verbose")
    opts.deterministic = getattr(ns, "threads_mode") == 1
    opts.threads_level = getattr(ns, "threads_level")
    opts.partitioning_tendency_window = getattr(ns, "threads_ptw")
    opts.double_precision = getattr(ns, "double_precision")
    opts.extension = ns.ext
    opts.fastexp = ns.fastexp
    opts.relative_progress = getattr(ns, "relative_progress")
    opts.mesh_sp = getattr(ns, "mesh_sp")
    opts.mesh_dp = getattr(ns, "mesh_dp")
    opts.coordinator = getattr(ns, "coordinator")
    opts.n_hosts = getattr(ns, "n_hosts")
    opts.host_id = getattr(ns, "host_id")
    opts.two_tier_min = getattr(ns, "two_tier_min")
    opts.checkpoint_file = ns.checkpoint
    return opts


def report_settings(opts, log):
    """Startup banner (ref VeryFastTree.cpp:131-259): the alignment, the
    distances, joins and supports, and under ML the model line."""
    print(f"{constants.NAME} Version {constants.VERSION} (PyTorch/CUDA)"
          + (" Double precision" if opts.double_precision else ""), file=log)
    print(f"Alignment: {opts.in_file_name or 'standard input'}", file=log)
    ml = opts.ml_nni != 0 or opts.ml_len
    support = "none"
    if opts.n_bootstrap > 0:
        support = f"SH-like {opts.n_bootstrap}" if ml \
            else f"Local boot {opts.n_bootstrap}"
    dist = opts.matrix_prefix or ("BLOSUM45" if opts.use_matrix else (
        "Jukes-Cantor" if opts.n_codes == 4 and opts.logdist
        else "%different"))
    print(f"{'Amino acid' if opts.n_codes == 20 else 'Nucleotide'} distances: "
          f"{dist} Joins: {'weighted' if opts.bionj else 'balanced'} "
          f"Support: {support}", file=log)
    if ml:
        if opts.n_codes == 4:
            model = "Generalized Time-Reversible" if opts.use_gtr \
                else "Jukes-Cantor"
        else:
            model = opts.transition_file or (
                "Le-Gascuel 2008" if opts.use_lg else "Whelan-And-Goldman"
                if opts.use_wag else "Jones-Taylor-Thorton")
        cats = "No rate variation across sites" if opts.n_rate_cats == 1 \
            else f"CAT approximation with {opts.n_rate_cats} rate categories"
        print(f"ML Model: {model}, {cats}", file=log)


def rank_device(device, host_id: int) -> torch.device:
    """The card of this rank: `device` where it names one, else
    cuda:VFT_LOCAL_RANK (the launcher's rank on its host), else
    cuda:host_id.  More ranks than cards raises."""
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("VFT_LOCAL_RANK", host_id))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f"rank {host_id} needs cuda:{local}, and this "
                           f"host has {torch.cuda.device_count()} card(s): "
                           "more ranks than cards")
    return torch.device("cuda", local)


def launch_local(argv, n_ranks: int, device) -> int:
    """Run the command as n_ranks rank processes on this host, rank i on
    cuda:i (or the CPU, as `device` says), with a rendezvous on a free
    local port.  Returns 0, or the exit code of the first rank that failed
    after stopping the others."""
    if device.type == "cuda" and n_ranks > torch.cuda.device_count():
        raise RuntimeError(f"the mesh needs {n_ranks} ranks, one per card, "
                           f"and this host has {torch.cuda.device_count()}")
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        address = f"127.0.0.1:{sock.getsockname()[1]}"
    code = ("import sys; from veryfasttree_tpu_torch.cli import main; "
            f"sys.exit(main(sys.argv[1:], device={device.type!r}))")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = []
    for i in range(n_ranks):
        env = dict(os.environ, VFT_COORDINATOR=address,
                   VFT_N_HOSTS=str(n_ranks), VFT_HOST_ID=str(i),
                   VFT_LOCAL_RANK=str(i),
                   PYTHONPATH=os.pathsep.join(
                       [root] + [p for p in [os.environ.get("PYTHONPATH")]
                                 if p]))
        procs.append(subprocess.Popen([sys.executable, "-c", code, *argv],
                                      env=env, stdin=subprocess.DEVNULL))
    rc, pending = 0, list(procs)
    try:
        while pending:
            for p in list(pending):
                r = p.poll()
                if r is None:
                    continue
                pending.remove(p)
                if r != 0 and rc == 0:
                    rc = r
                    for q in pending:
                        q.terminate()
            time.sleep(0.05)
    finally:        # an interrupted launcher leaves no rank behind
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


def main(argv=None, device="cuda") -> int:
    """The command line on `device` (a CUDA device unless the caller asks
    for the CPU, as the tests do)."""
    parser = build_parser()
    ns = parser.parse_args(argv)
    if ns.expert:
        parser.print_help()
        return 0
    if ns.help_:
        print(basic_help())
        return 0
    device = resolve_device(device)
    opts = args_to_options(ns)
    try:
        coords = multihost.coordinates(opts)
        if coords is None:
            n_ranks = requested_ranks(opts, torch.cuda.device_count()
                                      if device.type == "cuda" else 0)
            if n_ranks > 1:
                if not opts.in_file_name:
                    raise ValueError("a mesh run reads its alignment from a "
                                     "file, not standard input")
                return launch_local(sys.argv[1:] if argv is None else argv,
                                    n_ranks, device)
        else:
            device = rank_device(device, coords[2])
            multihost.maybe_init_distributed(opts, device)
    except (ValueError, RuntimeError) as e:
        print(f"ERROR: {e}", file=sys.stderr)
        return 1
    # every rank computes; only rank 0 writes the tree and the log, and a
    # non-primary rank never opens (and truncates) rank 0's files
    primary = multihost.is_primary()

    log_file = open(opts.log_file_name, "w") if opts.log_file_name \
        and primary else None
    quiet = None if primary else open(os.devnull, "w")
    log = quiet or (TeeStream(log_file, sys.stderr) if log_file
                    else sys.stderr)
    try:
        opts.derive_settings(log)
        if not opts.threads_explicit and opts.threads > 1:
            print(f"-threads {opts.threads} from OMP_NUM_THREADS: the batched "
                  "tier (-threads 1 keeps the serial tier)", file=log)
        if opts.verbose > 0:
            report_settings(opts, log)
        in_fp = open_maybe_compressed(opts.in_file_name) if opts.in_file_name \
            else sys.stdin
        out_fp = io.StringIO() if not primary else \
            open(opts.out_file_name, "w") if opts.out_file_name else sys.stdout
        try:
            run_pipeline(opts, in_fp, out_fp, log_fp=log, device=device)
        finally:
            if primary and opts.out_file_name:
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
        if quiet:
            quiet.close()
        if torch.distributed.is_available() \
                and torch.distributed.is_initialized():
            torch.distributed.destroy_process_group()
    return 0
