#!/usr/bin/env python3
"""Command-level benchmarks at bacterial scale (synthetic genomes).

Generates a 4 Mb reference plus N mutated samples, then times the real
CLI entry points (build / align / map aln / map vcf / lo / distance)
end to end, including IO. Each command gets:

  * an untimed device WARM-UP run (primes the persistent XLA compile
    cache and the page cache),
  * timed DEVICE runs with SKA_DISPATCH_STATS=1 (jit dispatch + compile
    counts land in the artifact), best-of-2, with every raw
    wall/user/sys triple recorded,
  * timed HOST runs (SKA_PLATFORM=cpu), best-of-2 — every row carries
    BOTH device and host seconds,
  * where csrc/ref_baseline provides one, the single-core REFERENCE
    PROXY e2e seconds for the same command on the same files.

It refuses to start unless JAX finds a GPU, and holds the device runs to
JAX's CUDA backend. A failed or timed-out run raises: no row is ever
measured on a fallback.

After the six standard commands, a `build_32x4Mb` row (32 samples, two
16-sample device batches) measures the batch-scale build (reference
merge_ska_dict.rs:354-417).

Run: `python scripts/bench_cmds.py --json out.json`.
"""

import argparse
import json
import os
import re
import resource
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent

_STATS_RE = re.compile(rb"SKA_DISPATCH_STATS (\{.*\})")


def make_genomes(d: Path, n_samples: int, length: int, seed=0, snp_rate=0.001,
                 ref_f=None):
    rng = np.random.default_rng(seed)
    bases = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(bases, size=length)
    if ref_f is None:
        ref_f = d / "ref.fa"
        with open(ref_f, "wb") as f:
            f.write(b">ref chr1\n")
            f.write(ref.tobytes() + b"\n")
    sample_files = []
    for i in range(n_samples):
        g = ref.copy()
        n_mut = int(length * snp_rate)
        pos = rng.choice(length, size=n_mut, replace=False)
        g[pos] = bases[(np.searchsorted(bases, g[pos]) + rng.integers(1, 4, n_mut)) % 4]
        p = d / f"sample_{i}.fa"
        with open(p, "wb") as f:
            f.write(b">sample_%d\n" % i)
            f.write(g.tobytes() + b"\n")
        sample_files.append(p)
    return ref_f, sample_files


def build_ref_proxy():
    """(Re)build csrc/ref_baseline if stale; returns exe path or None."""
    exe = REPO / "csrc" / "ref_baseline"
    srcs = [REPO / "csrc" / "ref_baseline.cpp", REPO / "csrc" / "skanative.cpp"]
    try:
        if not exe.exists() or max(s.stat().st_mtime for s in srcs) > exe.stat().st_mtime:
            subprocess.run(
                ["g++", "-O3", "-march=native", "-std=c++17", "-o", str(exe)]
                + [str(s) for s in srcs],
                check=True, capture_output=True,
            )
        return exe
    except Exception as e:  # noqa: BLE001 - proxy is best-effort
        print(f"ref proxy build failed: {e}", file=sys.stderr)
        return None


_PROXY_KEYS = [("ref_build_s", "build"), ("ref_align_s", "align"),
               ("ref_map_aln_s", "map_aln"), ("ref_map_vcf_s", "map_vcf"),
               ("ref_lo_s", "lo"), ("ref_distance_s", "distance")]


def run_ref_proxy(exe, k, ref_f, out_prefix, samples, timeout=900, runs=2,
                  only=None):
    """Run the e2e reference proxy (best of `runs` — shared host, noisy
    load); returns {cmd: seconds} or {}. `only` limits to a command
    subset (e.g. ["build"] for the 32-sample row)."""
    best = {}
    mode = "e2e" if not only else "e2e:" + ",".join(only)
    try:
        for _ in range(runs):
            out = subprocess.run(
                [str(exe), mode, str(k), str(ref_f), str(out_prefix)]
                + [str(s) for s in samples],
                check=True, capture_output=True, timeout=timeout,
            ).stdout
            rec = json.loads(out)
            for key, cmd in _PROXY_KEYS:
                v = rec.get(key)
                if v is None:
                    continue
                if cmd not in best or v < best[cmd]:
                    best[cmd] = v
    except Exception as e:  # noqa: BLE001
        print(f"ref proxy run failed: {e}", file=sys.stderr)
    return best


def require_gpu() -> str:
    """The kind of the GPU that device runs use, read by a short child
    (the caller stays off the card); raises when JAX finds none."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    env.pop("SKA_PLATFORM", None)
    r = subprocess.run(
        [sys.executable, "-c",
         "from ska_tpu.jaxinit import jax; d = jax.devices()[0]; "
         "print(d.platform, d.device_kind, sep='\\t')"],
        capture_output=True, text=True, timeout=420, cwd=str(REPO), env=env,
    )
    platform, _, kind = r.stdout.strip().partition("\t")
    if r.returncode or platform != "gpu":
        raise RuntimeError("no CUDA device available to JAX: "
                           f"{platform or r.stderr[-1000:]}")
    return kind


def run(cmd, timeout=None, env=None):
    """Run the CLI; returns (wall_s, user_s, sys_s, CompletedProcess).

    user/sys come from a RUSAGE_CHILDREN delta (runs are serial, so the
    delta is this child's).
    """
    full_env = dict(os.environ)
    if env:
        full_env.update(env)
    ru0 = resource.getrusage(resource.RUSAGE_CHILDREN)
    t0 = time.perf_counter()
    # the `ska` launcher is the product CLI: it routes dispatch-free
    # subcommands (align/nk/merge/delete/weed/lo) to the host pre-Python,
    # so "device" rows for those commands measure the real user-facing
    # path. SKA_PYTHON pins the interpreter the launcher execs to this one.
    full_env.setdefault("SKA_PYTHON", sys.executable)
    r = subprocess.run(
        [str(REPO / "ska")] + [str(c) for c in cmd],
        capture_output=True,
        timeout=timeout,
        env=full_env,
    )
    if r.returncode:
        raise RuntimeError(
            f"`ska {' '.join(map(str, cmd))}` exited {r.returncode}: "
            f"{r.stderr[-2000:].decode('utf-8', 'replace')}")
    wall = time.perf_counter() - t0
    ru1 = resource.getrusage(resource.RUSAGE_CHILDREN)
    return wall, ru1.ru_utime - ru0.ru_utime, ru1.ru_stime - ru0.ru_stime, r


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("-n", type=int, default=4, help="samples")
    ap.add_argument("-L", type=int, default=4_000_000, help="genome length")
    ap.add_argument("-k", type=int, default=31)
    ap.add_argument("--json", default=None, metavar="PATH",
                    help="also write the table as a JSON record")
    ap.add_argument("--cmd-timeout", type=float, default=900.0,
                    help="hard wall cap per run in seconds")
    ap.add_argument("--no-warm", action="store_true",
                    help="skip the untimed device warm-up runs")
    ap.add_argument("--scale-samples", type=int, default=32,
                    help="sample count for the scale build row "
                         "(build_NxLMb); 0 disables it")
    args = ap.parse_args()
    # device runs inherit this: a missing or broken card fails them
    os.environ["JAX_PLATFORMS"] = "cuda"
    os.environ.pop("SKA_PLATFORM", None)
    kind = require_gpu()
    print(f"device: {kind}")
    # the host engines from csrc/ now, not inside a timed run
    subprocess.run([sys.executable, "-I",
                    str(REPO / "ska_tpu" / "io" / "nativebuild.py"),
                    "library", "ska_host"], check=True)

    rows = []  # one dict per command, run order

    def write_json(platform="pending"):
        """Write/refresh the artifact after every command."""
        if not args.json:
            return
        rec = {
            "platform": platform,
            "device_kind": kind,
            "config": {"n_samples": args.n, "genome_len": args.L, "k": args.k,
                       "snp_rate": 0.001},
            "methodology": (
                "end-to-end `ska <cmd>` subprocess wall time incl. IO and "
                "interpreter startup on synthetic mutated genomes "
                "(scripts/bench_cmds.py). Per command: one untimed device "
                "warm-up (compile cache), then timed device runs "
                "(best-of-2; jit dispatch counts attached) and timed host "
                "runs (SKA_PLATFORM=cpu, best-of-2) — both sides min over "
                "their recorded runs, all raw [wall, user, sys] triples in "
                "*_runs_detail. ref_proxy_seconds = csrc/ref_baseline e2e "
                "single-core command proxy on the same files; "
                "*_vs_ref_proxy = ref_proxy/ours (>1 means we're faster). "
                "Commands are launched via the `ska` launcher, which "
                "auto-routes dispatch-free subcommands (align/nk/merge/"
                "delete/weed/lo) to the jax-free host path pre-Python — "
                "for those rows device and host columns measure the same "
                "engine. *_windows_per_sec_incl_io is a whole-command "
                "rate, NOT the bench.py on-chip kernel metric."),
            "unit": "seconds",
            "results": rows,
        }
        tmp = args.json + ".tmp"
        with open(tmp, "w") as f:
            json.dump(rec, f, indent=1)
        os.replace(tmp, args.json)

    def bench(name, cmd, ref_proxy_s=None):
        row = {"cmd": name}
        if not args.no_warm:  # untimed: compiles + page cache
            row["device_warmup_seconds"] = round(
                run(cmd, timeout=args.cmd_timeout)[0], 2)
        dev_runs = []
        for _ in range(2):
            *t, r = run(cmd, timeout=args.cmd_timeout,
                        env={"SKA_DISPATCH_STATS": "1"})
            dev_runs.append([round(x, 2) for x in t])
            m = _STATS_RE.search(r.stderr or b"")
            if m:
                stats = json.loads(m.group(1))
                row["jit_dispatches"] = stats.get("jit_dispatches")
                row["backend_compiles"] = stats.get("backend_compiles")
        row["device_seconds"] = min(t[0] for t in dev_runs)
        row["device_runs_detail"] = dev_runs
        print(f"{name:<9}: device {row['device_seconds']:7.2f}s  "
              f"(dispatches={row.get('jit_dispatches')}, "
              f"runs={[t[0] for t in dev_runs]})")
        host_runs = [
            [round(x, 2) for x in run(cmd, timeout=args.cmd_timeout,
                                      env={"SKA_PLATFORM": "cpu"})[:3]]
            for _ in range(2)
        ]
        row["host_seconds"] = min(t[0] for t in host_runs)
        row["host_seconds_runs"] = [t[0] for t in host_runs]
        row["host_runs_detail"] = host_runs
        print(f"{name:<9}: host   {row['host_seconds']:7.2f}s  "
              f"(runs={row['host_seconds_runs']})")

        if ref_proxy_s is not None:
            row["ref_proxy_seconds"] = round(ref_proxy_s, 2)
            for side in ("device", "host"):
                if row[f"{side}_seconds"]:  # 0.00 only at toy sizes
                    row[f"{side}_vs_ref_proxy"] = round(
                        ref_proxy_s / row[f"{side}_seconds"], 3)
        rows.append(row)
        write_json()
        return row["device_seconds"]

    with tempfile.TemporaryDirectory() as td:
        d = Path(td)
        print(f"generating {args.n} x {args.L/1e6:.1f} Mb genomes ...")
        ref_f, samples = make_genomes(d, args.n, args.L)

        # single-core reference e2e proxy on the same files
        ref_proxy = {}
        exe = build_ref_proxy()
        if exe:
            ref_proxy = run_ref_proxy(exe, args.k, ref_f, d / "rp", samples)
            if ref_proxy:
                print("ref proxy:", " ".join(
                    f"{c}={s:.2f}s" for c, s in ref_proxy.items()))

        bench("build", ["build", "-o", d / "all", "-k", args.k] + samples,
              ref_proxy.get("build"))
        windows = args.n * (args.L - args.k + 1)
        for side in ("device", "host"):
            # whole-command windows/s INCLUDING io + startup: not
            # comparable to the bench.py on-chip kernel metric
            rows[-1][f"{side}_windows_per_sec_incl_io"] = round(
                windows / rows[-1][f"{side}_seconds"])

        bench("align", ["align", d / "all.skf", "-o", d / "out.aln"],
              ref_proxy.get("align"))
        bench("map_aln",
              ["map", ref_f, d / "all.skf", "-o", d / "out_map.aln"],
              ref_proxy.get("map_aln"))
        bench("map_vcf",
              ["map", ref_f, d / "all.skf", "-f", "vcf", "-o", d / "out.vcf"],
              ref_proxy.get("map_vcf"))
        bench("lo", ["lo", "-r", ref_f, d / "all.skf", d / "lo_out"],
              ref_proxy.get("lo"))
        bench("distance", ["distance", d / "all.skf", "-o", d / "dists.tsv"],
              ref_proxy.get("distance"))

        # batch-scale build row (reference scaling surface
        # merge_ska_dict.rs:354-417)
        ns = args.scale_samples
        if ns and ns > args.n:
            name = f"build_{ns}x{args.L // 1_000_000}Mb"
            print(f"generating {ns} x {args.L/1e6:.1f} Mb genomes ...")
            (d / "scale").mkdir()
            _, scale_samples = make_genomes(d / "scale", ns, args.L, ref_f=ref_f)
            scale_proxy = {}
            if exe:
                scale_proxy = run_ref_proxy(
                    exe, args.k, ref_f, d / "scale" / "rp", scale_samples,
                    only=["build"])
                if scale_proxy:
                    print(f"ref proxy ({name}):"
                          f" build={scale_proxy['build']:.2f}s")
            bench(name, ["build", "-o", d / "scale" / "all",
                         "-k", args.k] + scale_samples,
                  scale_proxy.get("build"))
            windows = ns * (args.L - args.k + 1)
            for side in ("device", "host"):
                rows[-1][f"{side}_windows_per_sec_incl_io"] = round(
                    windows / rows[-1][f"{side}_seconds"])

    if args.json:
        write_json(platform="gpu")
        print(f"wrote {args.json}")


if __name__ == "__main__":
    main()
