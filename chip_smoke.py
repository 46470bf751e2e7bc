#!/usr/bin/env python3
"""Prove the ska product path on one NVIDIA GPU.

Runs the real CLI (`ska build`, `map` as aln and VCF, `distance`) on
synthetic cohorts made from --seed, on the device path, and compares every
output byte for byte with the host engines (`SKA_PLATFORM=cpu ./ska ...`:
the native `ska_host` binary or the csrc engines, both built here from
csrc/ before the first phase), which never touch the card. Then checks
the distance Gram kernels against an independent exact Gram at cohort
width, and times the pipeline's two big sorts.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --four     # the mesh path on four cards, nothing else

Phases (default mode): device; cohort A (4 x 4 Mb) at k=31 and at k=63;
cohort B (32 x 4 Mb, the multi-batch build) with the plain lax.sort times;
a 50x paired FASTQ read set; the Gram kernels.

Each phase prints one JSON line. The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}.
Any failure raises, so the script exits non-zero without that line. It
refuses to run without a CUDA device or outside a checkout of the repo.

One process owns the card: device commands run in this process through
the CLI's own entry point (ska_tpu.cli.main, what ./ska execs), and the
host-engine runs are child processes pinned to the CPU.
"""

import argparse
import filecmp
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

REPO = Path(__file__).resolve().parent

# host-engine runs: explicit host mode, and no card visible at all
HOST_ENV = {"SKA_PLATFORM": "cpu", "JAX_PLATFORMS": "cpu",
            "CUDA_VISIBLE_DEVICES": ""}


@dataclass
class Sizes:
    """Cohort and kernel sizes; the defaults are the real ones. The CPU
    rehearsal tests pass tiny ones."""

    genome_len: int = 4_000_000  # bacterial-size assemblies
    n_a: int = 4  # cohort A samples
    n_b: int = 32  # cohort B samples: two 16-sample device batches
    read_genome_len: int = 1_000_000
    coverage: int = 50
    sort_rows: tuple = (16, 1 << 22)  # 16 x 4M u64 rows


def check_checkout():
    missing = [p for p in ("ska", "ska_tpu", "csrc", "scripts/bench_cmds.py")
               if not (REPO / p).exists()]
    if missing:
        raise SystemExit("chip_smoke.py must run from a checkout of the "
                         f"repository (missing: {', '.join(missing)})")


def final_line(platform: str, kind: str, count: int) -> str:
    return json.dumps(
        {"ok": True, "device": {"platform": platform, "kind": kind,
                                "count": count}})


def same_bytes(a: Path, b: Path, names) -> dict:
    """{name: True iff a/name and b/name both exist with equal bytes}."""
    return {
        n: (a / n).is_file() and (b / n).is_file()
        and filecmp.cmp(a / n, b / n, shallow=False)
        for n in names
    }


def emit(rec: dict):
    print(json.dumps(rec), flush=True)


def device_stats() -> dict:
    from ska_tpu.jaxinit import CACHE_DIR, jax

    stats = jax.devices()[0].memory_stats() or {}
    return {"cache_dir": jax.config.jax_compilation_cache_dir or CACHE_DIR,
            "peak_bytes_in_use": stats.get("peak_bytes_in_use")}


def run_device(argv) -> float:
    """One CLI command on the device path, in this process."""
    from ska_tpu.cli import main

    t0 = time.perf_counter()
    main([str(a) for a in argv])
    return time.perf_counter() - t0


def bench_cmds():
    if str(REPO / "scripts") not in sys.path:
        sys.path.insert(0, str(REPO / "scripts"))
    import bench_cmds

    return bench_cmds


def run_host(argv) -> float:
    """The same command on the host engines: a CPU-pinned child through
    the `ska` launcher (the command runner of scripts/bench_cmds.py)."""
    return bench_cmds().run(argv, env=HOST_ENV)[0]


def compare_phase(phase: str, work: Path, cmds, warm: bool = True) -> dict:
    """Run `cmds` on the host engines, then on the device (cold, and warm
    when asked), and require byte-identical outputs.

    cmds: [(name, argv_fn(out_dir) -> argv, output file name)], run in
    order in each output directory (later commands may read earlier
    outputs, e.g. map reads build's .skf).
    """
    sides = ["host", "cold"] + (["warm"] if warm else [])
    times = {s: {} for s in sides}
    for side in sides:
        out = work / phase / side
        out.mkdir(parents=True, exist_ok=True)
        run = run_host if side == "host" else run_device
        for name, argv_fn, _ in cmds:
            times[side][name] = run(argv_fn(out))
    names = [f for _, _, f in cmds]
    files = {}
    for side in sides[1:]:
        for n, ok in same_bytes(work / phase / "host", work / phase / side,
                                names).items():
            files[f"{side}/{n}"] = ok
    rec = {"phase": phase}
    for side in sides:
        rec[f"{side}_s"] = sum(times[side].values())
    rec["commands"] = {
        name: {f"{s}_s": times[s][name] for s in sides} for name, _, _ in cmds
    }
    rec.update(device_stats())
    rec["identical"] = all(files.values())
    rec["files"] = files
    emit(rec)
    if not rec["identical"]:
        raise RuntimeError(f"{phase}: device and host outputs differ: "
                           f"{[f for f, ok in files.items() if not ok]}")
    return rec


def cohort_cmds(ref, samples, k, with_vcf=True, with_map=True,
                with_distance=True):
    cmds = [("build", lambda o: ["build", "-o", o / "all", "-k", k, *samples],
             "all.skf")]
    if with_map:
        cmds.append(("map_aln", lambda o: ["map", ref, o / "all.skf", "-o",
                                           o / "map.aln"], "map.aln"))
    if with_vcf:
        cmds.append(("map_vcf", lambda o: ["map", ref, o / "all.skf", "-f",
                                           "vcf", "-o", o / "map.vcf"],
                     "map.vcf"))
    if with_distance:
        cmds.append(("distance", lambda o: ["distance", o / "all.skf", "-o",
                                            o / "dist.tsv"], "dist.tsv"))
    return cmds


def make_cohort(d: Path, n: int, length: int, seed: int):
    d.mkdir(parents=True, exist_ok=True)
    return bench_cmds().make_genomes(d, n, length, seed=seed)


def make_reads(d: Path, genome_len: int, coverage: int, seed: int,
               read_len: int = 150):
    """Paired reads with qualities from one random genome: fragments of
    300-500 bp from either strand, 0.2% substitution errors (their
    k-mers fall under --min-count), and 2% low-quality bases (Q2-19,
    which the strict quality filter drops). Returns the -f file list."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    comp = np.zeros(256, np.uint8)
    comp[acgt] = np.frombuffer(b"TGCA", np.uint8)
    g = rng.choice(acgt, size=genome_len)
    n = coverage * genome_len // (2 * read_len)
    frag = rng.integers(300, 501, n)
    start = rng.integers(0, genome_len - frag + 1)
    off = np.arange(read_len)
    fwd = g[start[:, None] + off]
    rev = comp[g[(start + frag - read_len)[:, None] + off]][:, ::-1]
    flip = rng.random(n) < 0.5  # fragment from the other strand
    r1 = np.where(flip[:, None], rev, fwd)
    r2 = np.where(flip[:, None], fwd, rev)
    d.mkdir(parents=True, exist_ok=True)
    ids = (np.arange(n)[:, None] // 10 ** np.arange(7, -1, -1)) % 10 + 48
    paths = []
    for mate, r in ((1, r1), (2, r2)):
        err = rng.random(r.shape) < 0.002
        r[err] = acgt[(np.searchsorted(acgt, r[err])
                       + rng.integers(1, 4, int(err.sum()))) % 4]
        q = rng.integers(30, 41, r.shape)
        low = rng.random(r.shape) < 0.02
        q[low] = rng.integers(2, 20, int(low.sum()))
        hdr = np.concatenate(
            [np.full((n, 2), [ord("@"), ord("r")]), ids,
             np.full((n, 3), [ord("/"), 48 + mate, 10])], axis=1)
        rec = np.concatenate(
            [hdr, r, np.full((n, 3), [10, ord("+"), 10]), q + 33,
             np.full((n, 1), 10)], axis=1).astype(np.uint8)
        p = d / f"reads_{mate}.fastq"
        p.write_bytes(rec.tobytes())
        paths.append(p)
    lst = d / "reads.tsv"
    lst.write_text(f"reads\t{paths[0]}\t{paths[1]}\n")
    return lst


def time_sorts(shape, seed: int) -> dict:
    """Plain lax.sort on the card at the build's sizes: the
    single-operand dedup sort (per-sample rows, unstable) and the
    multi-operand merged sort ((key, sample id) keys + a set payload
    over all rows, unstable), as ops/pipeline.py runs them."""
    from ska_tpu.jaxinit import jax, jnp

    S, L = shape
    rk = jax.random.key(seed)
    keys = jax.random.bits(rk, (S, L), dtype=jnp.uint64)
    sid = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[:, None],
                           (S, L)).reshape(-1)
    sets = (keys.reshape(-1) & jnp.uint64(15)).astype(jnp.uint8)

    dedup = jax.jit(lambda k: jax.lax.sort(
        (k,), num_keys=1, dimension=-1, is_stable=False)[0])
    merged = jax.jit(lambda k, s, p: jax.lax.sort(
        (k.reshape(-1), s, p), num_keys=2, is_stable=False))

    out = {}
    for name, fn, args in (("dedup_1op", dedup, (keys,)),
                           ("merged_3op", merged, (keys, sid, sets))):
        t0 = time.perf_counter()
        res = jax.block_until_ready(fn(*args))
        cold = time.perf_counter() - t0
        warm = []
        for _ in range(3):
            t0 = time.perf_counter()
            res = jax.block_until_ready(fn(*args))
            warm.append(time.perf_counter() - t0)
        k0 = res if name == "dedup_1op" else res[0]
        if not bool(jnp.all(k0[..., 1:] >= k0[..., :-1])):
            raise RuntimeError(f"lax.sort {name} output is not sorted")
        out[name] = {"cold_s": cold, "warm_s": sorted(warm)[1],
                     "warm_runs_s": warm}
    out["rows"] = S * L
    return out


def reference_gram(variants):
    """Independent exact 16-class Gram of a (sites, n) ASCII matrix:
    unique rows with counts, then f64 BLAS over the integer one-hot in
    chunks (every sum is an integer below 2^53, so exact)."""
    import numpy as np

    from ska_tpu.encoding import ASCII_TO_SET

    classes = ASCII_TO_SET[variants].astype(np.uint8)
    S, n = classes.shape
    rows, counts = np.unique(
        np.ascontiguousarray(classes).view(np.dtype((np.void, n))).ravel(),
        return_counts=True)
    u = rows.view(np.uint8).reshape(-1, n).astype(np.int64)
    G = np.zeros((n * 16, n * 16))
    cols = np.arange(n) * 16
    for c0 in range(0, len(u), 1 << 16):
        blk = u[c0:c0 + (1 << 16)]
        X = np.zeros((len(blk), n * 16))
        X[np.arange(len(blk))[:, None], cols + blk] = 1.0
        G += (X * counts[c0:c0 + len(blk), None]).T @ X
    return G.astype(np.int64)


def _lowering(jitted, *args, **static) -> dict:
    """What XLA made of a Gram kernel on this backend: custom-call
    targets (cuBLAS / cuBLASLt / Triton GEMM) and the dot's precision."""
    txt = jitted.lower(*args, **static).compile().as_text()
    return {
        "custom_calls": sorted(set(re.findall(
            r'custom_call_target="([^"]+)"', txt))),
        "fusion_kinds": sorted(set(re.findall(r'"kind":"(__[a-z_]+)"', txt))),
        "operand_precision": sorted(set(re.findall(
            r'"operand_precision":\[([^\]]*)\]', txt))),
        "algorithm": sorted(set(re.findall(r'"algorithm":"([A-Z0-9_]+)"',
                                           txt))),
        "dot_in_hlo": bool(re.search(r"= [a-z0-9\[\]{},]+ dot\(", txt)),
    }


def phase_gram(skf_path: Path, seed: int) -> dict:
    """Both accelerator Gram kernels on cohort B's variant matrix (after
    the NoConst filter `ska distance` applies), and the weighted f32
    kernel at the f32-exactness edge, against exact integer Grams."""
    import numpy as np

    from ska_tpu import api
    from ska_tpu import distance as D
    from ska_tpu.io import skf
    from ska_tpu.jaxinit import jnp

    arr = skf.load(str(skf_path))
    api.apply_filters(arr, 0.0, False, "no-const", False, False)
    variants = arr.variants
    want = reference_gram(variants)
    rec = {"phase": "gram", "sites": int(variants.shape[0]),
           "samples": int(variants.shape[1])}
    ceiling = D.DEDUP_MAX_SITES
    try:
        for name, cap in (("int8", 0), ("weighted_f32", ceiling)):
            D.DEDUP_MAX_SITES = cap  # 0 forces the undeduped int8 kernel
            t = []
            for _ in range(2):
                t0 = time.perf_counter()
                got = D.class_gram(variants, on_host=False)
                t.append(time.perf_counter() - t0)
            rec[name] = {"cold_s": t[0], "warm_s": t[1],
                         "exact": bool(np.array_equal(got, want))}
    finally:
        D.DEDUP_MAX_SITES = ceiling

    # f32 exactness edge: odd integer weights summing to 2^24 - 1, which
    # TF32 (10-bit mantissa) or bf16 products could not represent
    rng = np.random.default_rng(seed)
    C, n, width = 1024, 32, 8
    cl = rng.integers(0, width, size=(C, n)).astype(np.int8)
    w = rng.integers(1, 32767, size=C).astype(np.int64) | 1
    w[0] = (1 << 24) - 1 - int(w[1:].sum())
    X = np.eye(width, dtype=np.int64)[cl].reshape(C, n * width)
    edge = np.asarray(D._gram_chunk_weighted(
        jnp.asarray(cl), jnp.asarray(w), n, width, False), np.int64)
    rec["weighted_f32_edge_exact"] = bool(
        np.array_equal(edge, (X * w[:, None]).T @ X))

    compact, _, _, cw, _ = D.compact_classes(variants[:1024])
    c = jnp.asarray(compact)
    nn = compact.shape[1]
    rec["lowering"] = {
        "int8": _lowering(D._jitted("_gram_chunk"), c, n=nn, width=cw),
        "weighted_f32": _lowering(
            D._jitted("_gram_chunk_weighted"), c,
            jnp.ones(len(compact), jnp.int64), n=nn, width=cw, f64=False),
    }
    rec.update(device_stats())
    rec["identical"] = (rec["int8"]["exact"] and rec["weighted_f32"]["exact"]
                        and rec["weighted_f32_edge_exact"])
    emit(rec)
    if not rec["identical"]:
        raise RuntimeError("gram: a device Gram differs from the exact Gram")
    return rec


def run_single(work: Path, seed: int, sizes: Sizes):
    """Every default-mode phase after the device check."""
    ref_a, samples_a = make_cohort(work / "cohort_a", sizes.n_a,
                                   sizes.genome_len, seed)
    compare_phase("cohort_a_k31", work, cohort_cmds(ref_a, samples_a, 31))
    compare_phase("cohort_a_k63", work,
                  cohort_cmds(ref_a, samples_a, 63, with_vcf=False,
                              with_distance=False))

    ref_b, samples_b = make_cohort(work / "cohort_b", sizes.n_b,
                                   sizes.genome_len, seed + 1)
    compare_phase("cohort_b", work,
                  cohort_cmds(ref_b, samples_b, 31, with_vcf=False,
                              with_map=False))
    emit({"phase": "sorts", **time_sorts(sizes.sort_rows, seed),
          **device_stats(), "identical": True})  # sortedness checked

    lst = make_reads(work / "reads_in", sizes.read_genome_len,
                     sizes.coverage, seed + 2)
    compare_phase("reads", work, [
        ("build_fastq", lambda o: ["build", "-f", lst, "-o", o / "reads",
                                   "-k", 31], "reads.skf")])

    phase_gram(work / "cohort_b" / "cold" / "all.skf", seed)


def run_four(work: Path, seed: int, sizes: Sizes):
    """Cohort B's build sharded over the device mesh, then the sharded
    map lookup and distance Gram, each against the host engines."""
    from ska_tpu.parallel import use_distributed

    if not use_distributed():
        raise RuntimeError("--four: the mesh path is not selected "
                           "(needs more than one device)")
    ref_b, samples_b = make_cohort(work / "cohort_b", sizes.n_b,
                                   sizes.genome_len, seed + 1)
    compare_phase("mesh_cohort_b", work,
                  cohort_cmds(ref_b, samples_b, 31, with_vcf=False))


def build_native() -> dict:
    """The host engines from the committed csrc/ sources (nothing built is
    committed), before any phase: the shared library that both sides
    load and the `ska_host` front-end the host side execs."""
    from ska_tpu.io import nativebuild

    out = {}
    for name, build in (("library", nativebuild.library),
                        ("ska_host", nativebuild.host_cli)):
        t0 = time.perf_counter()
        build()
        out[name] = time.perf_counter() - t0
    return out


def nvidia_smi_lines(four: bool):
    cmd = ["nvidia-smi", "--query-gpu=name,power.limit",
           "--format=csv,noheader"]
    vis = os.environ.get("CUDA_VISIBLE_DEVICES", "")
    if not four and vis.split(",")[0].strip().isdigit():
        cmd.append(f"--id={vis.split(',')[0].strip()}")
    out = subprocess.run(cmd, check=True, capture_output=True, text=True,
                         timeout=60).stdout
    return [ln.strip() for ln in out.splitlines() if ln.strip()]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--four", action="store_true",
                    help="run only the four-card mesh path and its check")
    args = ap.parse_args(argv)
    check_checkout()

    # the card, and only the card: an explicit platform makes a missing
    # or broken CUDA backend an error instead of a fallback to the CPU
    os.environ["JAX_PLATFORMS"] = "cuda"
    for var in ("SKA_PLATFORM", "SKA_DISTRIBUTED", "SKA_NATIVE_BUILD"):
        os.environ.pop(var, None)
    if not args.four:
        # one card even on a multi-card host, or use_distributed() would
        # silently take the mesh path
        os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")

    t_start = time.perf_counter()
    from ska_tpu.jaxinit import jax

    try:
        devs = jax.devices()
    except Exception as e:  # noqa: BLE001 - any backend failure: no card
        raise SystemExit(f"no CUDA device available to JAX: {e!r}")
    dev = devs[0]
    want = 4 if args.four else 1
    if dev.platform != "gpu" or len(devs) != want:
        raise SystemExit(f"need {want} GPU(s), found {len(devs)} "
                         f"{dev.platform} device(s)")
    gpus = nvidia_smi_lines(args.four)
    for line in gpus:
        print(line, flush=True)
    emit({"phase": "device", "platform": dev.platform,
          "kind": dev.device_kind, "count": len(devs),
          "jax": jax.__version__, "native_build_s": build_native(),
          **device_stats()})

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as td:
        (run_four if args.four else run_single)(Path(td), args.seed, Sizes())

    emit({"phase": "total", "wall_s": time.perf_counter() - t_start,
          "gpus": gpus})
    print(final_line(dev.platform, dev.device_kind, len(devs)), flush=True)


if __name__ == "__main__":
    main()
