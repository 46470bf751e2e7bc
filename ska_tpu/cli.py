"""Command line interface mirroring the reference's clap CLI
(src/cli.rs:167-426 and main() dispatch, src/lib.rs:557-892):
build, align, map, distance, merge, delete, weed, nk, cov, lo.
"""

import argparse
import logging
import os
import sys
import time

from .constants import (
    DEFAULT_AMBIGMASK,
    DEFAULT_AMBIGMISSING,
    DEFAULT_CONSTGAPS,
    DEFAULT_KMER,
    DEFAULT_MAX_INDEL_KMERS,
    DEFAULT_MAX_PATHDEPTH,
    DEFAULT_MINCOUNT,
    DEFAULT_MINFREQ,
    DEFAULT_MINQUAL,
    DEFAULT_MISSING_SKALO,
    DEFAULT_REPEATMASK,
    QUAL_FILTER_NAMES,
    check_k,
)

log = logging.getLogger("ska_tpu")


def _valid_kmer(s):
    try:
        return check_k(int(s))
    except ValueError as e:
        raise argparse.ArgumentTypeError(str(e))


def _zero_to_one(s):
    f = float(s)
    if not 0.0 <= f <= 1.0:
        raise argparse.ArgumentTypeError("Frequency must be between 0 and 1 (inclusive)")
    return f


def _threads(s):
    t = int(s)
    if t < 1:
        raise argparse.ArgumentTypeError("Threads must be one or higher")
    return t


def _min_count(s):
    if s == "auto":
        return "auto"
    x = int(s)
    if x < 1:
        raise argparse.ArgumentTypeError("Minimum kmer count must be >= 1")
    return x


def build_parser():
    p = argparse.ArgumentParser(
        prog="ska",
        description="SKA: Split K-mer Analysis, the alignment-free aligner",
    )
    p.add_argument("-v", "--verbose", action="store_true", help="Show progress messages")
    # the reference (clap) accepts -v after the subcommand too; SUPPRESS
    # keeps the subparser from clobbering a -v given before the subcommand
    common = argparse.ArgumentParser(add_help=False)
    common.add_argument(
        "-v",
        "--verbose",
        action="store_true",
        default=argparse.SUPPRESS,
        help="Show progress messages",
    )
    sub = p.add_subparsers(dest="command", required=True)
    _orig_add_parser = sub.add_parser

    def _add_parser(*a, **kw):
        kw.setdefault("parents", [common])
        return _orig_add_parser(*a, **kw)

    sub.add_parser = _add_parser

    filt_choices = ["no-filter", "no-const", "no-ambig", "no-ambig-or-const"]

    b = sub.add_parser("build", help="Create a split-kmer file from input sequences")
    b.add_argument("seq_files", nargs="*", help="List of input FASTA files")
    b.add_argument("-f", dest="file_list", help="File listing input files")
    b.add_argument("-o", dest="output", required=True, help="Output prefix")
    b.add_argument("-k", type=_valid_kmer, default=DEFAULT_KMER, help="K-mer size")
    b.add_argument("--proportion-reads", type=_zero_to_one, default=None)
    b.add_argument("--single-strand", action="store_true")
    b.add_argument("--min-count", type=_min_count, default=None)
    b.add_argument("--min-qual", type=int, default=DEFAULT_MINQUAL)
    b.add_argument("--qual-filter", choices=list(QUAL_FILTER_NAMES), default="strict")
    b.add_argument("--threads", type=_threads, default=None)

    a = sub.add_parser("align", help="Write an unordered alignment")
    a.add_argument("input", nargs="+", help="A .skf file, or list of .fasta files")
    a.add_argument("-o", dest="output", default=None)
    a.add_argument("-m", "--min-freq", type=_zero_to_one, default=DEFAULT_MINFREQ)
    a.add_argument("--filter-ambig-as-missing", action="store_true", default=DEFAULT_AMBIGMISSING)
    a.add_argument("--filter", choices=filt_choices, default="no-const")
    a.add_argument("--ambig-mask", action="store_true", default=DEFAULT_AMBIGMASK)
    a.add_argument("--no-gap-only-sites", action="store_true", default=DEFAULT_CONSTGAPS)
    a.add_argument("--threads", type=_threads, default=None)

    m = sub.add_parser("map", help="Write an ordered alignment using a reference sequence")
    m.add_argument("reference")
    m.add_argument("input", nargs="+")
    m.add_argument("-o", dest="output", default=None)
    m.add_argument("-f", "--format", choices=["vcf", "aln"], default="aln")
    m.add_argument("--ambig-mask", action="store_true", default=DEFAULT_AMBIGMASK)
    m.add_argument("--repeat-mask", action="store_true", default=DEFAULT_REPEATMASK)
    m.add_argument("--threads", type=_threads, default=None)

    d = sub.add_parser("distance", help="Calculate SNP distances and k-mer mismatches")
    d.add_argument("skf_file")
    d.add_argument("-o", dest="output", default=None)
    d.add_argument("-m", "--min-freq", type=_zero_to_one, default=0.0)
    d.add_argument("--allow-ambiguous", action="store_true")
    d.add_argument("--threads", type=_threads, default=None)

    g = sub.add_parser("merge", help="Combine multiple split k-mer files")
    g.add_argument("skf_files", nargs="+")
    g.add_argument("-o", dest="output", required=True)

    de = sub.add_parser("delete", help="Remove samples from a split k-mer file")
    de.add_argument("-s", "--skf-file", required=True)
    de.add_argument("-o", dest="output", default=None)
    de.add_argument("-f", dest="file_list", default=None)
    de.add_argument("names", nargs="*")

    w = sub.add_parser("weed", help="Remove k-mers from a split k-mer file")
    w.add_argument("skf_file")
    w.add_argument("weed_file", nargs="?", default=None)
    w.add_argument("-o", dest="output", default=None)
    w.add_argument("--reverse", action="store_true")
    w.add_argument("-m", "--min-freq", type=_zero_to_one, default=DEFAULT_MINFREQ)
    w.add_argument("--filter-ambig-as-missing", action="store_true")
    w.add_argument("--filter", choices=filt_choices, default="no-filter")
    w.add_argument("--ambig-mask", action="store_true")
    w.add_argument("--no-gap-only-sites", action="store_true")

    n = sub.add_parser("nk", help="Get the number of k-mers in a split k-mer file")
    n.add_argument("skf_file")
    n.add_argument("--full-info", action="store_true")

    c = sub.add_parser("cov", help="Estimate a coverage cutoff from FASTQ k-mer counts")
    c.add_argument("fastq_fwd")
    c.add_argument("fastq_rev")
    c.add_argument("-k", type=_valid_kmer, default=DEFAULT_KMER)
    c.add_argument("--single-strand", action="store_true")

    lo = sub.add_parser("lo", help="Finds 'left out' SNPs and INDELs using a graph")
    lo.add_argument("input_skf")
    lo.add_argument("output")
    lo.add_argument("-r", "--reference", default=None)
    lo.add_argument("-m", "--missing", type=float, default=DEFAULT_MISSING_SKALO)
    lo.add_argument("-d", "--depth", type=int, default=DEFAULT_MAX_PATHDEPTH)
    lo.add_argument("-n", "--indel-kmers", type=int, default=DEFAULT_MAX_INDEL_KMERS)
    lo.add_argument("--threads", type=_threads, default=None)

    return p


def _is_primary() -> bool:
    """True unless this is a secondary process of a multi-process run.

    Only SKA_COORDINATOR-configured jax.distributed runs (init_multihost
    in _main) have secondary processes. Must not touch the JAX backend
    in the single-process case: jax.process_count() force-initializes
    the XLA client, which (a) brings up the GPU runtime for host-only
    commands that never dispatch, and (b) under a tight RLIMIT_AS aborts
    the whole process inside absl (Eigen pool pthread_create CHECK)
    instead of raising a catchable MemoryError — the `ska lo`
    OOM-guidance path must stay abort-free.
    """
    if os.environ.get("SKA_COORDINATOR"):
        from .parallel import is_primary

        return is_primary()
    return True


def _ostream(output, binary=False):
    if output is None:
        return sys.stdout.buffer if binary else sys.stdout
    if not _is_primary():
        # multi-process run: every process computes the identical result
        # but only host 0 writes files — concurrent writes to one path on a
        # shared filesystem would interleave
        return open(os.devnull, "wb" if binary else "w")
    return open(output, "wb" if binary else "w")


def main(argv=None):
    # a downstream `| head` closes stdout early; exit silently like the
    # reference binary's default SIGPIPE disposition instead of tracing
    try:
        return _main(argv)
    except BrokenPipeError:
        try:
            sys.stdout.close()
        except BrokenPipeError:
            pass
        sys.exit(141)  # 128 + SIGPIPE
    except MemoryError as e:
        # the skalo guards raise MemoryError WITH guidance — surface it
        # instead of a traceback; a bare MemoryError from elsewhere keeps
        # its traceback (the allocation site is the useful part there)
        if not str(e):
            raise
        print(f"Error: {e}", file=sys.stderr)
        sys.exit(1)


def _main(argv=None):
    args = build_parser().parse_args(argv)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(levelname)s [%(name)s] %(message)s",
        stream=sys.stderr,
    )
    print("SKA: Split K-mer Analysis (the alignment-free aligner)", file=sys.stderr)
    start = time.time()

    if args.command in ("align", "distance", "build", "map", "nk", "weed",
                        "delete", "merge"):
        # pinned-host route: the one-pass C++ engines (csrc/host_modes.cpp)
        # answer these commands before numpy even imports (build: plain
        # FASTA cohorts only — the same gate as the r4 native engine;
        # map: single-.skf input with a plain-FASTA reference);
        # any unsupported case falls through to the python pipeline below
        from . import host_cmds

        if host_cmds.try_run(args.command, args):
            _footer(start)
            return

    from . import api
    from .io import fastx, skf
    from .sampletypes import QualOpts

    cmd = args.command
    if os.environ.get("SKA_COORDINATOR"):
        # multi-host deployment: join the process group before any device
        # use so the build mesh spans every host (parallel/multihost.py)
        from .parallel import init_multihost

        init_multihost()

    profile_dir = os.environ.get("SKA_PROFILE")
    if profile_dir:
        # device-level tracing: SKA_PROFILE=<dir> wraps the whole command
        # in a JAX profiler trace (viewable with tensorboard/xprof).
        # Must come AFTER init_multihost: start_trace force-initializes
        # the backends, and jax.distributed.initialize has to run first
        # or the process group join fails / the mesh spans one host only.
        from .jaxinit import jax

        jax.profiler.start_trace(profile_dir)
    # the reference sizes a rayon pool with this flag (main.rs via
    # rayon::ThreadPoolBuilder); here the device pipeline replaces
    # rayon for build/map/distance compute, and the host-bound native
    # cores (skalo traversal/SNP stages, AlnWriter) read SKA_THREADS
    # to size their own pthread pools — outputs are byte-identical at
    # any thread count (test_skalo_core.py::test_native_thread_count_
    # invariant). An explicit --threads N wins over an inherited
    # SKA_THREADS (and --threads 1 resets a lingering value); without
    # the flag the env var stands.
    cli_threads = getattr(args, "threads", None)
    if cli_threads is not None:
        os.environ["SKA_THREADS"] = str(cli_threads)
    eff_threads = int(os.environ.get("SKA_THREADS", "1") or 1)
    if eff_threads > 1:
        logging.getLogger("ska_tpu").info(
            "--threads %d: host-side native stages use a %d-thread pool "
            "(device compute is batched on the accelerator regardless)",
            eff_threads, eff_threads,
        )
    if cmd != "build" and not _is_primary():
        # only `build` distributes over the process mesh; every other command
        # is host-local, so secondary processes would just duplicate the
        # primary's work and race it for the output files
        logging.getLogger("ska_tpu").info(
            "secondary process: '%s' runs on host 0 only", cmd
        )
        return
    if cmd == "build":
        input_files = fastx.get_input_list(args.file_list, args.seq_files or None)
        rc = not args.single_strand
        min_count = _resolve_min_count(args, input_files, rc)
        qual = QualOpts(
            min_count=min_count,
            min_qual=args.min_qual,
            qual_filter=QUAL_FILTER_NAMES[args.qual_filter],
        )
        arr = api.build(input_files, args.k, rc, qual, args.proportion_reads)
        if _is_primary():
            skf.save(arr, args.output)
    elif cmd == "align":
        arr = api.load_array(args.input)
        fh = _ostream(args.output, binary=True)
        api.align(
            arr,
            fh,
            filter_type=args.filter,
            ambig_mask=args.ambig_mask,
            ignore_const_gaps=args.no_gap_only_sites,
            min_freq=args.min_freq,
            filter_ambig_as_missing=args.filter_ambig_as_missing,
        )
        fh.flush()
    elif cmd == "map":
        arr = api.load_array(args.input)
        binary = args.format == "aln"
        fh = _ostream(args.output, binary=binary)
        api.map_mode(arr, args.reference, fh, args.format, args.ambig_mask, args.repeat_mask)
        fh.flush()
    elif cmd == "distance":
        arr = skf.load(args.skf_file)
        fh = _ostream(args.output)
        api.distance_mode(arr, fh, args.min_freq, not args.allow_ambiguous)
        fh.flush()
    elif cmd == "merge":
        if len(args.skf_files) < 2:
            raise SystemExit("Need at least two files to merge")
        api.merge_mode(args.skf_files, args.output)
    elif cmd == "delete":
        input_files = fastx.get_input_list(args.file_list, args.names or None)
        names = [t[0] for t in input_files]
        arr = skf.load(args.skf_file)
        api.delete_mode(arr, names, args.output or args.skf_file)
    elif cmd == "weed":
        arr = skf.load(args.skf_file)
        api.weed_mode(
            arr,
            args.weed_file,
            args.reverse,
            args.min_freq,
            args.filter_ambig_as_missing,
            args.filter,
            args.ambig_mask,
            args.no_gap_only_sites,
            args.output or args.skf_file,
        )
    elif cmd == "nk":
        arr = skf.load(args.skf_file)
        print(arr.nk_display())
        if args.full_info:
            print(arr.nk_full_info())
    elif cmd == "cov":
        from .coverage import CoverageHistogram

        cov = CoverageHistogram(
            args.fastq_fwd, args.fastq_rev, args.k, not args.single_strand, args.verbose
        )
        cutoff = cov.fit_histogram()
        cov.plot_hist()
        print(f"Estimated cutoff\t{cutoff}", file=sys.stderr)
    elif cmd == "lo":
        from .skalo import run_skalo, SkaloConfig

        arr = api.load_array([args.input_skf])
        config = SkaloConfig(
            output_name=args.output,
            max_missing=args.missing,
            max_depth=args.depth,
            max_indel_kmers=args.indel_kmers,
            reference_genome=args.reference,
        )
        run_skalo(arr, config)

    if profile_dir:
        from .jaxinit import jax

        jax.profiler.stop_trace()
        log.info("profiler trace written to %s", profile_dir)

    _footer(start)


def _footer(start):
    elapsed = int(time.time() - start)
    print(f"SKA done in {elapsed}s", file=sys.stderr)
    print("⬛⬜⬛⬜⬛⬜⬛", file=sys.stderr)
    print("⬜⬛⬜⬛⬜⬛⬜", file=sys.stderr)


def _resolve_min_count(args, input_files, rc) -> int:
    """--min-count auto fits the coverage model on the first two FASTQ
    samples' forward reads (reference io_utils.rs:175-212)."""
    mc = args.min_count
    if mc is None:
        return DEFAULT_MINCOUNT
    if mc != "auto":
        return mc
    fastqs = [t for t in input_files if t[2] is not None]
    if len(fastqs) >= 2:
        from .coverage import CoverageHistogram

        cov = CoverageHistogram(fastqs[0][1], fastqs[1][1], args.k, rc, args.verbose)
        out = cov.fit_histogram()
        cov.plot_hist()
        log.info("Using inferred minimum kmer value of %d", out)
        return out
    log.info("Not enough fastq files to fit mixture model, using default kmer count of 5")
    return DEFAULT_MINCOUNT


if __name__ == "__main__":
    main()
