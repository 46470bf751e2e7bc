"""Native host-mode command routing for the dispatch-free subcommands
(align, distance, map, build, nk, weed, delete, merge).

These commands never dispatch device work; on the host path their wall
time was dominated by CPython + numpy startup (~0.3 s — more than the
whole single-core reference command, generic_modes.rs:22-50,136-189).
This module is imported by the CLI BEFORE any numpy-importing module and
calls the one-pass C++ engines in csrc/host_modes.cpp via ctypes; any
failure (odd .skf encoding, allocation, unknown flag) returns False and
the CLI falls through to the canonical python pipeline. Byte-identity of
both routes is pinned by tests/test_host_cmds.py.

Deliberately imports NOTHING beyond the stdlib: pulling ska_tpu.io.native
here would import numpy and give the startup time back.
"""

import ctypes
import os
import re

_FILTER_MODE = {"no-filter": 0, "no-const": 1, "no-ambig": 2,
                "no-ambig-or-const": 3}

# extension-stripped sample naming (reference io_utils.rs:31-46); kept in
# sync with io/fastx.py by tests/test_host_cmds.py (fastx imports numpy,
# which this module must never pull)
_RE_PATH = re.compile(r"^.+/(.+)\.(?i:fa|fasta|fastq|fastq\.gz)$")
_RE_NAME = re.compile(r"^(.+)\.(?i:fa|fasta|fastq|fastq\.gz)$")

_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    so = os.environ.get("SKA_NATIVE_SO") or os.path.join(
        os.path.dirname(__file__), "io", "_skanative.so"
    )
    lib = ctypes.CDLL(so)
    lib.ska_host_align.restype = ctypes.c_longlong
    lib.ska_host_align.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
    ]
    lib.ska_host_distance.restype = ctypes.c_longlong
    lib.ska_host_distance.argtypes = [
        ctypes.c_char_p, ctypes.c_char_p, ctypes.c_double, ctypes.c_int,
    ]
    try:  # absent in older builds of the .so: map falls back to python
        lib.ska_host_map.restype = ctypes.c_longlong
        lib.ska_host_map.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_char_p,
            ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
        lib.ska_host_nk.restype = ctypes.c_longlong
        lib.ska_host_nk.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.ska_host_weed.restype = ctypes.c_longlong
        lib.ska_host_weed.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_char_p,
        ]
        lib.ska_host_delete.restype = ctypes.c_longlong
        lib.ska_host_delete.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_char_p,
        ]
        lib.ska_host_merge.restype = ctypes.c_longlong
        lib.ska_host_merge.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.ska_host_align_fasta.restype = ctypes.c_longlong
        lib.ska_host_align_fasta.argtypes = [
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_longlong, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_double, ctypes.c_int, ctypes.c_int, ctypes.c_int,
            ctypes.c_int,
        ]
        lib.ska_host_map_fasta.restype = ctypes.c_longlong
        lib.ska_host_map_fasta.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ]
    except AttributeError:
        pass
    try:  # absent in older builds of the .so: build falls back to python
        lib.ska_host_build_files.restype = ctypes.c_longlong
        lib.ska_host_build_files.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_longlong, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong,
        ]
        lib.ska_host_build_files2.restype = ctypes.c_longlong
        lib.ska_host_build_files2.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_longlong,
            ctypes.c_char_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_char_p,
            ctypes.c_longlong,
        ]
    except AttributeError:
        pass
    _lib = lib
    return lib


def _build_inputs(args):
    """(name, path) pairs for a plain-FASTA cohort, or None to decline
    (FASTQ, pairs, gz, unreadable). Mirrors fastx.get_input_list /
    read_input_fastas without importing them (numpy)."""
    trips = _build_inputs_any(args)
    if trips is None:
        return None
    out = []
    for name, f1, f2 in trips:
        if f2 is not None:
            return None
        try:
            with open(f1, "rb") as f:
                if f.read(1) != b">":
                    return None  # FASTQ / gz / junk
        except OSError:
            return None
        out.append((name, f1))
    return out


def _build_inputs_any(args):
    """(name, file1, file2-or-None) triples for ANY cohort (FASTA, FASTQ
    pairs, gz); None only on parse errors. fastx.get_input_list shape."""
    if args.file_list:
        out = []
        try:
            with open(args.file_list) as f:
                for line in f:
                    fields = line.split()
                    if not fields:
                        continue
                    if len(fields) == 2:
                        out.append((fields[0], fields[1], None))
                    elif len(fields) == 3:
                        out.append((fields[0], fields[1], fields[2]))
                    else:
                        return None  # python raises the parse error
        except OSError:
            return None
    else:
        out = []
        for p in args.seq_files or []:
            m = _RE_PATH.match(p) or _RE_NAME.match(p)
            out.append((m.group(1) if m else p, p, None))
    return out or None


def _fasta_blobs(input_list):
    """NUL-separated (names, paths) for an all-plain-FASTA list of >= 2
    files (the implicit-build gate, api.load_array); None to decline."""
    if len(input_list) < 2:
        return None
    names = []
    for p in input_list:
        m = _RE_PATH.match(p) or _RE_NAME.match(p)
        names.append(m.group(1) if m else p)
        try:
            with open(p, "rb") as f:
                if f.read(1) != b">":
                    return None  # FASTQ / gz / .skf mixed in: python route
        except OSError:
            return None
    return (b"\x00".join(n.encode() for n in names),
            b"\x00".join(p.encode() for p in input_list))


def _eligible(args):
    """Native route only on the pinned host backend, single-process,
    unless disabled; device runs keep the accelerator pipeline."""
    if os.environ.get("SKA_PLATFORM") != "cpu":
        return False
    if os.environ.get("SKA_NATIVE_CMDS", "1") == "0":
        return False
    if os.environ.get("SKA_COORDINATOR"):
        return False  # multi-process runs: only host 0 writes (cli._ostream)
    return True


def try_run(cmd, args) -> bool:
    """Returns True when the native engine fully handled the command."""
    if not _eligible(args):
        return False
    try:
        lib = _load()
    except Exception:  # noqa: BLE001 - missing .so/symbols: python route
        return False
    if cmd == "build" and not hasattr(lib, "ska_host_build_files"):
        return False
    out = (getattr(args, "output", None) or "-").encode()
    try:
        if cmd == "align":
            mode = _FILTER_MODE.get(args.filter)
            if mode is None:
                return False
            if len(args.input) == 1:
                rc = lib.ska_host_align(
                    args.input[0].encode(), out, float(args.min_freq), mode,
                    int(bool(args.filter_ambig_as_missing)),
                    int(bool(args.ambig_mask)),
                    int(bool(args.no_gap_only_sites)),
                )
                return rc == 0
            blobs = _fasta_blobs(args.input)
            if blobs is None:
                return False  # FASTQ/gz cohorts: python pipeline
            names, paths = blobs
            rc = lib.ska_host_align_fasta(
                paths, len(paths), names, len(names), len(args.input), out,
                float(args.min_freq), mode,
                int(bool(args.filter_ambig_as_missing)),
                int(bool(args.ambig_mask)),
                int(bool(args.no_gap_only_sites)),
            )
            return rc == 0
        if cmd == "distance":
            rc = lib.ska_host_distance(
                args.skf_file.encode(), out, float(args.min_freq),
                int(not args.allow_ambiguous),
            )
            return rc == 0
        if cmd == "map":
            # the engine's pthread pools read SKA_THREADS; an explicit
            # --threads wins over an inherited value (cli.py contract,
            # normally applied after this fast-path would have returned)
            if args.threads is not None:
                os.environ["SKA_THREADS"] = str(args.threads)
            if len(args.input) == 1:
                try:
                    with open(args.input[0], "rb") as f:
                        if f.read(1) == b">":
                            return False  # single FASTA: python raises
                except OSError:
                    return False
                rc = lib.ska_host_map(
                    args.reference.encode(), args.input[0].encode(), out,
                    int(args.format == "vcf"), int(bool(args.ambig_mask)),
                    int(bool(args.repeat_mask)),
                )
                return rc == 0
            blobs = _fasta_blobs(args.input)
            if blobs is None:
                return False
            names, paths = blobs
            rc = lib.ska_host_map_fasta(
                args.reference.encode(), paths, len(paths), names,
                len(names), len(args.input), out,
                int(args.format == "vcf"), int(bool(args.ambig_mask)),
                int(bool(args.repeat_mask)),
            )
            return rc == 0
        if cmd == "nk":
            rc = lib.ska_host_nk(args.skf_file.encode(),
                                 int(bool(args.full_info)))
            return rc == 0
        if cmd == "weed":
            mode = _FILTER_MODE.get(args.filter)
            if mode is None:
                return False
            out_w = (args.output or args.skf_file).encode()  # exact path
            rc = lib.ska_host_weed(
                args.skf_file.encode(),
                args.weed_file.encode() if args.weed_file else None,
                int(bool(args.reverse)), float(args.min_freq), mode,
                int(bool(args.filter_ambig_as_missing)),
                int(bool(args.ambig_mask)),
                int(bool(args.no_gap_only_sites)), out_w,
            )
            return rc == 0
        if cmd == "delete":
            if args.file_list:
                names = []
                try:
                    with open(args.file_list) as f:
                        for line in f:
                            fields = line.split()
                            if not fields:
                                continue
                            if len(fields) != 2:
                                return False
                            names.append(fields[0])
                except OSError:
                    return False
            else:
                names = []
                for p in args.names or []:
                    m = _RE_PATH.match(p) or _RE_NAME.match(p)
                    names.append(m.group(1) if m else p)
            if not names:
                return False
            out_d = args.output or args.skf_file
            if not out_d.endswith(".skf"):
                out_d += ".skf"
            blob = b"\x00".join(n.encode() for n in names)
            rc = lib.ska_host_delete(args.skf_file.encode(), blob,
                                     len(blob), len(names), out_d.encode())
            return rc == 0
        if cmd == "merge":
            if len(args.skf_files) < 2 or not args.output:
                return False  # python raises its canonical errors
            out_m = args.output
            if not out_m.endswith(".skf"):
                out_m += ".skf"
            blob = b"\x00".join(p.encode() for p in args.skf_files)
            from . import __version__

            ver_m = __version__.encode()
            rc = lib.ska_host_merge(blob, len(blob), len(args.skf_files),
                                    out_m.encode(), ver_m, len(ver_m))
            return rc == 0
        if cmd == "build":
            if os.environ.get("SKA_NATIVE_BUILD") == "0":
                return False  # documented kill switch for native builds
            if args.proportion_reads is not None:
                return False  # read subsampling: python pipeline
            if args.min_count == "auto":
                return False  # coverage-model fit: python pipeline
            path = args.output
            if not path.endswith(".skf"):
                path = path + ".skf"
            from . import __version__

            ver = __version__.encode()
            inputs = _build_inputs(args)
            if inputs is not None:
                # pure plain-FASTA cohort: the r4 engine
                names = b"\x00".join(n.encode("utf-8") for n, _p in inputs)
                paths = b"\x00".join(p.encode("utf-8") for _n, p in inputs)
                rc = lib.ska_host_build_files(
                    path.encode(), paths, len(paths), len(inputs), names,
                    len(names), int(args.k), int(not args.single_strand),
                    ver, len(ver),
                )
                return rc == 0
            # FASTQ / gz / paired cohorts: the r5 quality+count engine
            trips = _build_inputs_any(args)
            if trips is None or not hasattr(lib, "ska_host_build_files2"):
                return False
            qf = {"no-filter": 0, "middle": 1, "strict": 2}.get(
                args.qual_filter)
            if qf is None:
                return False
            from .constants import DEFAULT_MINCOUNT

            mc = (DEFAULT_MINCOUNT if args.min_count is None
                  else int(args.min_count))
            names = b"\x00".join(n.encode() for n, _1, _2 in trips)
            p1 = b"\x00".join(f1.encode() for _n, f1, _2 in trips)
            p2 = b"\x00".join((f2 or "").encode() for _n, _1, f2 in trips)
            rc = lib.ska_host_build_files2(
                path.encode(), p1, len(p1), p2, len(p2), len(trips),
                names, len(names), int(args.k),
                int(not args.single_strand), qf, int(args.min_qual), mc,
                ver, len(ver),
            )
            return rc == 0
    except Exception:  # noqa: BLE001 - any native hiccup: python route
        return False
    return False
