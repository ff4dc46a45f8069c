#!/usr/bin/env python3
"""Time variants of B2's float32 kernel (``flash_f32_kernel``) on one
card, in one process, on the same inputs.

Run from the root of a checkout on a machine with an NVIDIA GPU:

    python3 scripts/b2_f32_variants.py [--shapes 16,64,4,40;8,512,16,64]
        [--variant 'OLD=>NEW' ...] [--source NAME=PATH ...]

Each ``--variant 'OLD=>NEW'`` is a copy of ``csrc/flash_attention.cu``
with the text OLD, which must occur exactly once, replaced by NEW; for
example ``'kMinBlocks = 128;=>kMinBlocks = 256;'`` (query rows per block
follow the grid) or ``'j < kKeys; ++j) {=>j < 0; ++j) {'`` (no P.V, to
time what remains). Each
``--source NAME=PATH`` is another copy of the whole source with the same
C entry point, such as the parent commit's (``git archive`` into the
git-ignored ``_chipcheck/``). The copies are built, every nvcc at once,
into the git-ignored ``nornicdb_tpu_torch/_build/variants/``, anew each
time. The source as it stands runs as ``default``. Every call goes
through ``ops/attention.py:launch``, the wrapper's own launch. The
default's answer must agree with the plain version within
``chip_smoke.ATTN_F32_ATOL``. Each line says whether its library agrees
too (a variant that drops work does not) and whether it is bitwise the
default's. Each (shape, library) is timed twice, in the order default,
others, others reversed, default: CUDA events over back-to-back calls
and the device time per call (``torch.profiler``). Prints one line per
measurement, and writes them to ``chiprun_out/b2_f32_variants.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_libraries(variants, sources):
    """{name: bound library}; ``default`` is the source as it stands,
    variant i is named ``v<i>``, and each ``NAME=PATH`` source ``NAME``."""
    from nornicdb_tpu_torch.ops import _build
    from nornicdb_tpu_torch.ops.attention import bind

    pairs = []
    for spec in sources:
        name, sep, path = spec.partition("=")
        if not sep:
            raise ValueError(f"source {spec!r}: give NAME=PATH")
        pairs.append((name, path))
    libs = {}
    for name, (what, lib, log) in _build.build_variants(
            "flash_attention", variants, pairs).items():
        print(f"library {name}: {what}", flush=True)
        for line in _build.ptxas_lines(log):
            print(f"  ptxas[{name}]: {line}", flush=True)
        libs[name] = bind(lib)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--shapes", default="16,64,4,40;1,16,4,40;16,512,4,40;8,512,16,64",
                    help="B,S,H,Dh;... (the f32 shapes of chip_smoke.ATTN_TIMED)")
    ap.add_argument("--variant", action="append", default=[],
                    help="OLD=>NEW: a patched copy of the source to time")
    ap.add_argument("--source", action="append", default=[],
                    help="NAME=PATH: another whole source to time")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("b2_f32_variants: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from nornicdb_tpu_torch import resolve_device
    from nornicdb_tpu_torch.ops.attention import launch, reference_attention

    dev = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {card}", flush=True)
    t0 = time.perf_counter()
    libs = build_libraries(args.variant, args.source)
    print(f"built {len(libs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rows = []
    for shape in args.shapes.split(";"):
        b, s, h, dh = (int(x) for x in shape.split(","))
        q, k, v = (torch.randn(b, s, h, dh, generator=gen, device=dev) for _ in range(3))
        lengths = torch.randint(s // 4, s + 1, (b,), generator=gen, device=dev)
        mask = torch.arange(s, device=dev)[None, :] < lengths[:, None]
        runs = {name: (lambda lib=lib: launch(lib, q, k, v, mask)) for name, lib in libs.items()}
        ref = reference_attention(q, k, v, mask)
        first = runs["default"]()
        same, agrees = {}, {}
        for name, run in runs.items():
            out = run()
            agrees[name] = float((out - ref).abs().max()) <= cs.ATTN_F32_ATOL
            same[name] = bool(torch.equal(out, first))
        if not agrees["default"]:
            raise AssertionError(f"the default disagrees with the plain version at {shape}")
        n_bytes, flops = cs.attn_cost(b, s, h, dh, 4)
        bnd, by = cs.bound_ms(n_bytes, flops)
        order = list(runs) + list(reversed(runs))
        for turn, name in enumerate(order):
            ms = cs.time_ms(runs[name], iters=50)
            split = cs.device_split(runs[name], iters=20, expect="flash_")
            row = {"B": b, "S": s, "H": h, "Dh": dh, "variant": name, "turn": turn,
                   "kernel_ms": ms, "device_ms": sum(split.values()), "device_split": split,
                   "bound_ms": bnd, "bound_by": by, "agrees": agrees[name],
                   "bitwise_default": same[name], "card": card}
            rows.append(row)
            print(f"B2 f32 {name} B={b} S={s} H={h} Dh={dh} [{card}]: kernel_ms {ms:.4f} "
                  f"device_ms {row['device_ms']:.4f} bound_ms {bnd:.4f} ({by}); agrees "
                  f"{agrees[name]}; bitwise default {same[name]}; kernels {json.dumps(split)}",
                  flush=True)
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "b2_f32_variants.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
