#!/usr/bin/env python3
"""Time variants of B1's batched stage 1 (``rtile_kernel``) on one card,
in one process, on the same inputs.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/b1_tile_variants.py [--rows N] [--dims D] [--k K]
        [--batch 8,64,256] [--variant 'OLD=>NEW' ...]

Each ``--variant 'OLD=>NEW'`` is a copy of ``csrc/cosine_topk.cu`` with
the text OLD, which must occur exactly once, replaced by NEW; for
example ``'kTileSlack = 32;=>kTileSlack = 8;'`` (candidate slots beyond
a round's), ``'kTileGroup = 8;=>kTileGroup = 16;'`` (rows loaded
together), ``'kTileStages = 2;=>kTileStages = 3;'`` (ring stages) or
``'return qb / 4;=>return qb == 64 ? 8 : qb / 4;'`` (rows per thread).
The copies are written and built, every nvcc at once, into the
git-ignored ``nornicdb_tpu_torch/_build/variants/``, built anew each
time. The source as it stands runs as ``default``. Every call goes
through ``ops/topk.py:launch``, the wrapper's own launch. Every
variant's answer must be bitwise the default's (each score sums the
depth in the same order whatever the tile), and the default's must
agree with the plain version tie-aware. Each (B, variant) is timed
twice, in the order default, variants, variants reversed, default: CUDA
events over back-to-back calls and the device time of each kernel per
call (``torch.profiler``). Prints one line per measurement, and writes
them to ``chiprun_out/b1_tile_variants.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_variants(variants):
    """{name: bound library}; ``default`` is the source as it stands, and
    variant i is named ``v<i>``."""
    from nornicdb_tpu_torch.ops import _build
    from nornicdb_tpu_torch.ops.topk import bind

    libs = {"default": bind(_build.library("cosine_topk"))}
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(_build.SRC_DIR, _build.SOURCES["cosine_topk"])) as f:
        src = f.read()
    procs = []
    for n, patch in enumerate(variants):
        old, sep, new = patch.partition("=>")
        if not sep or src.count(old) != 1:
            raise ValueError(f"variant {patch!r}: OLD must occur exactly once in the source")
        name = f"v{n}"
        path = os.path.join(out_dir, f"cosine_topk-{name}.cu")
        with open(path, "w") as f:
            f.write(src.replace(old, new))
        out = path[:-3] + ".so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", out, path]
        procs.append((name, patch, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    for name, patch, out, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"variant {name} ({patch}) failed to build:\n{log}")
        print(f"variant {name}: {patch}", flush=True)
        for line in log.splitlines():
            if "registers" in line or ("spill" in line and ", 0 bytes spill stores" not in line):
                print(f"  ptxas[{name}]: {line.strip()}", flush=True)
        libs[name] = bind(_build.load(out))
    return libs


def caller(lib, q, m, valid, k):
    """A function that runs one call of ``lib``'s top-k on these inputs
    through the wrapper's own launch."""
    from nornicdb_tpu_torch.ops.topk import launch

    grids = {}
    return lambda: launch(lib, grids, q, m, valid, k)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=1 << 20)
    ap.add_argument("--dims", type=int, default=1024)
    ap.add_argument("--k", type=int, default=10)
    ap.add_argument("--batch", default="8,64,256")
    ap.add_argument("--variant", action="append", default=[],
                    help="OLD=>NEW: a patched copy of the source to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("b1_tile_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nornicdb_tpu_torch import resolve_device
    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto
    from nornicdb_tpu_torch.ops.topk import topk_agree

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build_variants(args.variant)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    c, d, k = args.rows, args.dims, args.k
    m = torch.randn(c, d, generator=gen, device=dev)
    m /= m.norm(dim=1, keepdim=True)
    valid = torch.rand(c, generator=gen, device=dev) < 0.9
    rows = []
    for b in (int(x) for x in args.batch.split(",")):
        q = torch.randn(b, d, generator=gen, device=dev)
        q /= q.norm(dim=1, keepdim=True)
        runs = {name: caller(lib, q, m, valid, k) for name, lib in libs.items()}
        ref_s, ref_i = (x.clone() for x in runs["default"]())
        s_p, i_p = cosine_topk_auto(q, m, valid, k)
        if not topk_agree(ref_i.cpu().numpy(), ref_s.cpu().numpy(), i_p.cpu().numpy(),
                          s_p.cpu().numpy(), cs.TOPK_SCORE_ATOL):
            raise AssertionError(f"default disagrees with the plain version at B={b}")
        for name, run in runs.items():
            s, i = run()
            if not (torch.equal(s, ref_s) and torch.equal(i, ref_i)):
                raise AssertionError(f"variant {name} differs from default at B={b}")
        n_bytes, flops = cs.topk_cost(b, c, d, k)
        bnd, by = cs.bound_ms(n_bytes, flops)
        order = list(runs) + list(reversed(runs))
        for turn, name in enumerate(order):
            ms = cs.time_ms(runs[name], iters=10)
            split = cs.device_split(runs[name], iters=5, expect="merge_kernel")
            row = {"C": c, "D": d, "B": b, "k": k, "variant": name, "turn": turn,
                   "kernel_ms": ms, "device_ms": split, "bound_ms": bnd, "bound_by": by,
                   "card": card}
            rows.append(row)
            print(f"B1 variant {name} C={c} D={d} B={b} k={k} [{card}]: kernel_ms {ms:.4f} "
                  f"bound_ms {bnd:.4f} ({by}); device ms by stage {json.dumps(split)}",
                  flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "b1_tile_variants.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
