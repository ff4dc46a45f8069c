#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nornicdb_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--docs N] [--index-rows N]

Phases, in order; any failure exits non-zero:

1. Device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. Build: compiles both CUDA kernels from ``nornicdb_tpu_torch/csrc``.
3. Kernel vs plain version on the card, on seeded inputs: the fused
   cosine top-k (B1) against a matmul + mask + stable top-k, and flash
   attention (B2) against the materializing softmax.
4. Main path through the public entry points: ``open(device="cuda")`` with
   the committed mini encoder, ``store`` of seeded documents, ``flush``,
   64 queries each in vector, text and hybrid mode; both kernels' launch
   counters must grow, and the vector answers must match the plain path.
5. Index at deployment scale: a 1,048,576 x 1024 float32
   ``BruteForceIndex`` filled through ``add_batch`` and searched at
   B in {1, 64}, k = 10, through B1, checked against the plain path.

Timing uses CUDA events. The second-to-last line is a JSON object with
one entry per kernel; the last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
A copy of every measurement goes to ``chiprun_out/chip_smoke_report.json``.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12  # float32 outside the tensor cores

# Tolerances. Both kernels compute in float32 and differ from their plain
# versions only in the order of float sums (sequential fmaf against cuBLAS
# and torch's softmax reductions), so:
TOPK_SCORE_ATOL = 1e-5  # |cosine| <= 1 over D <= 1024 terms
ATTN_F32_ATOL = 2e-5    # outputs are convex combinations of |v| ~ 1 values
ATTN_BF16_ATOL = 2e-2   # bf16 output rounding (8 mantissa bits) on |out| < 4

REPORT: dict = {}


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def bound_ms(n_bytes: float, flops: float):
    """(least milliseconds the card could take, which roof binds)."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def topk_cost(b: int, c: int, d: int, k: int):
    """Bytes (matrix, queries, mask read once; scores + ids written once)
    and float32 FLOPs of one exact top-k call."""
    return c * d * 4 + b * d * 4 + c + b * k * 8, 2.0 * b * c * d


def attn_cost(b: int, s: int, h: int, dh: int, elem: int):
    """Bytes (q, k, v read once, out written once, mask) and FLOPs."""
    return 4 * b * s * h * dh * elem + b * s, 4.0 * b * h * s * s * dh


# -- phase 1 ---------------------------------------------------------------


def phase_device():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader", "-i", "0"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    REPORT["card"] = smi
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    from nornicdb_tpu_torch import resolve_device

    return resolve_device("cuda")  # also turns TF32 off for the plain versions


# -- phase 2 ---------------------------------------------------------------


def phase_build():
    from nornicdb_tpu_torch.ops import _build

    t0 = time.perf_counter()
    compile_s = _build.build()
    _build.library("cosine_topk")
    _build.library("flash_attention")
    total = time.perf_counter() - t0
    REPORT["build_s"] = total
    log(f"build: {total:.2f} s (nvcc {compile_s:.2f} s, both sources in parallel)")
    for name in _build.SOURCES:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or ("spill" in line and ", 0 bytes spill stores" not in line):
                log(f"  ptxas[{name}]: {line.strip()}")


# -- phase 3 ---------------------------------------------------------------


def _normalized(rng, n, d):
    x = rng.standard_normal((n, d)).astype(np.float32)
    return x / np.linalg.norm(x, axis=1, keepdims=True)


def check_topk(dev, rng, c, d, b, k, valid_frac=0.9):
    """One B1 case: masked rows, duplicated rows (exact ties), queries
    that hit the duplicates. Returns the max abs score error."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree

    m = _normalized(rng, c, d)
    n_dup = min(c // 4, 512)
    m[c - n_dup:] = m[:n_dup]  # exact duplicates -> exact score ties
    valid = rng.random(c) < valid_frac
    q = _normalized(rng, b, d)
    q[: b // 2] = m[rng.integers(0, n_dup, b // 2)]  # queries on duplicated rows
    qt, mt, vt = (torch.from_numpy(x).to(dev) for x in (q, m, valid))
    s_k, i_k = fused_cosine_topk(qt, mt, vt, k)
    s_p, i_p = cosine_topk(qt, mt, vt, k)
    torch.cuda.synchronize()
    s_k, i_k, s_p, i_p = (x.cpu().numpy() for x in (s_k, i_k, s_p, i_p))
    if s_k.shape != (b, min(k, c)) or not np.isfinite(s_k).all():
        raise AssertionError(f"B1 bad output shape/values at C={c} D={d} B={b} k={k}")
    err = float(np.abs(s_k - s_p).max())
    if not topk_agree(i_k, s_k, i_p, s_p, TOPK_SCORE_ATOL):
        raise AssertionError(
            f"B1 disagrees with its plain version at C={c} D={d} B={b} k={k} "
            f"(max score err {err:.3g})")
    return err


def check_attention(dev, rng, b, s, h, dh, dtype, atol):
    import torch

    from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention

    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    lengths = rng.integers(1, s + 1, b)
    lengths[0] = s
    mask = torch.from_numpy(np.arange(s)[None, :] < lengths[:, None]).to(dev)
    out = flash_attention(q, k, v, mask)
    ref = reference_attention(q, k, v, mask)
    torch.cuda.synchronize()
    if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"B2 bad output at B={b} S={s} H={h} Dh={dh} {dtype}")
    err = float((out.float() - ref.float()).abs().max())
    if err > atol:
        raise AssertionError(
            f"B2 disagrees with its plain version at B={b} S={s} H={h} Dh={dh} "
            f"{dtype}: max abs {err:.3g} > {atol}")
    return err


def phase_kernels(dev, seed):
    import torch

    rng = np.random.default_rng(seed)
    errs = []
    for d, c in ((160, 100_003), (1024, 30_011)):
        for b in (1, 7, 64, 256):
            for k in (1, 10, 30, 128, 256):
                errs.append(check_topk(dev, rng, c, d, b, k))
    # fewer valid rows than k: the tail carries the masked score
    errs.append(check_topk(dev, rng, 300, 160, 7, 256, valid_frac=0.3))
    REPORT["topk_max_abs_err"] = max(errs)
    log(f"B1 vs plain: {len(errs)} cases agree (tie-aware), max score err "
        f"{max(errs):.3g} <= {TOPK_SCORE_ATOL}")
    errs = []
    for h, dh in ((4, 40), (16, 64)):
        for s in (100, 128, 512):
            errs.append(check_attention(dev, rng, 8, s, h, dh, torch.float32, ATTN_F32_ATOL))
    REPORT["attention_max_abs_err"] = max(errs)
    bf = check_attention(dev, rng, 8, 128, 16, 64, torch.bfloat16, ATTN_BF16_ATOL)
    log(f"B2 vs plain: f32 max abs {max(errs):.3g} <= {ATTN_F32_ATOL}; "
        f"bf16 max abs {bf:.3g} <= {ATTN_BF16_ATOL}")


# -- phase 4 ---------------------------------------------------------------


def make_corpus(rng, n_docs, n_words=5000):
    letters = np.array(list("abcdefghijklmnopqrstuvwxyz"))
    vocab = ["".join(rng.choice(letters, rng.integers(3, 10))) for _ in range(n_words)]
    p = 1.0 / np.arange(1, n_words + 1)  # Zipf-like word frequencies
    p /= p.sum()
    lengths = rng.integers(10, 61, n_docs)
    words = rng.choice(n_words, size=int(lengths.sum()), p=p)
    docs, pos = [], 0
    for n in lengths:
        docs.append(" ".join(vocab[w] for w in words[pos:pos + n]))
        pos += n
    queries = [" ".join(vocab[w] for w in rng.choice(n_words, rng.integers(3, 7), p=p))
               for _ in range(64)]
    return docs, queries


def phase_main_path(dev, seed, n_docs):
    import torch

    import nornicdb_tpu_torch
    from nornicdb_tpu_torch.ops.attention import flash_attention
    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto, l2_normalize
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree

    rng = np.random.default_rng(seed + 1)
    docs, queries = make_corpus(rng, n_docs)

    flash_attention.launches = 0
    fused_cosine_topk.launches = 0
    db = nornicdb_tpu_torch.open(device=dev)
    t0 = time.perf_counter()
    for i, text in enumerate(docs):
        db.store(text, node_id=f"d{i}")
    store_s = time.perf_counter() - t0
    db.flush()
    flush_s = time.perf_counter() - t0 - store_s
    t1 = time.perf_counter()
    svc = db.search  # builds BM25 + vector indexes over the stored nodes
    index_s = time.perf_counter() - t1
    lat = {}
    results = {}
    for mode in ("vector", "text", "hybrid"):
        ts = []
        for q in queries:
            t = time.perf_counter()
            results[(mode, q)] = db.recall(q, limit=10, mode=mode)
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t) * 1e3)
        lat[mode] = ts
    launches = {"flash_attention": flash_attention.launches,
                "cosine_topk": fused_cosine_topk.launches}
    embedded = db._embedder.misses  # texts that reached the encoder
    log(f"main path launches: {launches} ({embedded} texts through the encoder)")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path never launched: {launches}")

    # right answers: hits are well-formed, and a stored document's own
    # text finds that document first in vector mode
    for (mode, q), hits in results.items():
        if not hits or len(hits) > 10:
            raise AssertionError(f"{mode} search for {q!r} returned {len(hits)} hits")
        if any(not np.isfinite(h["score"]) for h in hits):
            raise AssertionError(f"{mode} search returned a non-finite score")
    probe = [int(x) for x in rng.integers(0, n_docs, 16)]
    dup = {}
    for i, t in enumerate(docs):
        dup.setdefault(t, i)
    for i in probe:
        hit = db.recall(docs[i], limit=1, mode="vector")[0]
        if hit["id"] != f"d{dup[docs[i]]}" and abs(hit["score"] - 1.0) > 1e-5:
            raise AssertionError(f"doc d{i} is not its own nearest neighbour: {hit}")

    # embeddings on the card agree with the CPU port on a small input
    from nornicdb_tpu_torch.models.checkpoint import load_default_embedder

    cpu_emb = load_default_embedder("cpu")
    sample = docs[:8] + queries[:8]
    a = np.asarray(db._embedder.inner.embed_batch(sample))
    b = np.asarray(cpu_emb.embed_batch(sample))
    cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
    if cos.min() < 0.99999 or not np.isfinite(a).all() or a.shape != (16, 160):
        raise AssertionError(f"card vs CPU embedding cosine {cos.min():.7f} < 0.99999")

    # vector answers vs the plain path over the same device index
    vecs = svc.vectors
    with vecs._lock:
        m, valid = vecs._device_arrays_locked()
    qv = l2_normalize(torch.tensor(np.asarray(db._embedder.embed_batch(queries)),
                                   dtype=torch.float32, device=dev)).contiguous()
    s_k, i_k = fused_cosine_topk(qv, m, valid, 30)
    s_p, i_p = cosine_topk_auto(qv, m, valid, 30)
    s_k, i_k, s_p, i_p = (x.cpu().numpy() for x in (s_k, i_k, s_p, i_p))
    if not topk_agree(i_k, s_k, i_p, s_p, TOPK_SCORE_ATOL):
        raise AssertionError("main-path vector answers disagree with the plain path")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    mp = {
        "docs": n_docs, "store_docs_per_s": n_docs / store_s,
        "store_s": store_s, "flush_s": flush_s, "index_build_s": index_s,
        "embed_docs_per_s_incl_store": n_docs / (store_s + flush_s),
        "capacity": vecs._capacity, "dims": vecs.dims,
        "launches": launches,
        "queries_per_mode": len(queries),
        "texts_embedded": embedded,
        "launches_per_query": {
            # vector and hybrid searches each scan the index once
            "cosine_topk": launches["cosine_topk"] / (2 * len(queries)),
            # per text through the encoder (one launch per layer per batch)
            "flash_attention": launches["flash_attention"] / max(embedded, 1),
        },
    }
    for mode, ts in lat.items():
        mp[f"{mode}_p50_ms"] = pct(ts, 50)
        mp[f"{mode}_p99_ms"] = pct(ts, 99)
    REPORT["main_path"] = mp
    log(f"main path: stored {n_docs} docs at {mp['store_docs_per_s']:.0f} docs/s, "
        f"flush {flush_s:.2f} s, index build {index_s:.2f} s, "
        f"capacity {vecs._capacity} x {vecs.dims}")
    for mode in lat:
        log(f"  search {mode}: p50 {mp[mode + '_p50_ms']:.3f} ms "
            f"p99 {mp[mode + '_p99_ms']:.3f} ms")
    db.close()
    return launches, vecs


# -- timing at the main path's shapes -------------------------------------


def time_topk(dev, m, valid, b, k, seed, card):
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    c, d = m.shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(_normalized(rng, b, d)).to(dev)
    saved = fused_cosine_topk.launches
    kernel = time_ms(lambda: fused_cosine_topk(q, m, valid, k))
    fused_cosine_topk.launches = saved  # comparison launches do not count
    plain = time_ms(lambda: cosine_topk_auto(q, m, valid, k), iters=5)
    neg = torch.tensor(-1e30, device=dev)

    def library():
        s = torch.where(valid[None, :], torch.matmul(q, m.T), neg)
        return torch.topk(s, k, dim=1)

    lib = time_ms(library, iters=10)
    n_bytes, flops = topk_cost(b, c, d, k)
    bnd, by = bound_ms(n_bytes, flops)
    row = {"C": c, "D": d, "B": b, "k": k, "kernel_ms": kernel, "plain_ms": plain,
           "library_ms": lib, "bound_ms": bnd, "bound_by": by, "card": card}
    log(f"B1 C={c} D={d} B={b} k={k} [{card}]: kernel_ms {kernel:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} bound_ms {bnd:.4f} ({by})")
    return row


def time_attention(dev, b, s, h, dh, seed, card):
    import torch
    import torch.nn.functional as F

    from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32)).to(dev)
               for _ in range(3))
    lengths = rng.integers(s // 4, s + 1, b)
    mask = torch.from_numpy(np.arange(s)[None, :] < lengths[:, None]).to(dev)
    saved = flash_attention.launches
    kernel = time_ms(lambda: flash_attention(q, k, v, mask), iters=50)
    flash_attention.launches = saved
    plain = time_ms(lambda: reference_attention(q, k, v, mask), iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am = mask[:, None, None, :]
    lib = time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am), iters=50)
    n_bytes, flops = attn_cost(b, s, h, dh, 4)
    bnd, by = bound_ms(n_bytes, flops)
    row = {"B": b, "S": s, "H": h, "Dh": dh, "dtype": "float32", "kernel_ms": kernel,
           "plain_ms": plain, "library_ms": lib, "bound_ms": bnd, "bound_by": by,
           "card": card}
    log(f"B2 B={b} S={s} H={h} Dh={dh} f32 [{card}]: kernel_ms {kernel:.4f} plain_ms "
        f"{plain:.4f} library_ms {lib:.4f} bound_ms {bnd:.4f} ({by})")
    return row


# -- phase 5 ---------------------------------------------------------------


def phase_index(dev, seed, n_rows, card):
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk_auto
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree
    from nornicdb_tpu_torch.search.vector_index import BruteForceIndex

    d = 1024
    rng = np.random.default_rng(seed + 2)
    idx = BruteForceIndex(dims=d, device=dev)
    t0 = time.perf_counter()
    step = 65_536
    for start in range(0, n_rows, step):
        n = min(step, n_rows - start)
        vecs = rng.random((n, d), dtype=np.float32) - 0.5
        idx.add_batch([(f"v{start + j}", vecs[j]) for j in range(n)])
    fill_s = time.perf_counter() - t0
    log(f"index: filled {len(idx)} x {d} (capacity {idx._capacity}) in {fill_s:.2f} s")
    rows = []
    for b in (1, 64):
        queries = rng.random((b, d), dtype=np.float32) - 0.5
        before = fused_cosine_topk.launches
        t = time.perf_counter()
        hits = idx.search_batch(queries, k=10)
        first_s = time.perf_counter() - t
        if fused_cosine_topk.launches != before + 1:
            raise AssertionError("the deployment-scale index did not answer through B1")
        if len(hits) != b or any(len(h) != 10 for h in hits):
            raise AssertionError("index search returned the wrong number of hits")
        with idx._lock:
            m, valid = idx._device_arrays_locked()
        qn = torch.from_numpy(queries).to(dev)
        qn = qn / qn.norm(dim=1, keepdim=True)
        s_p, i_p = cosine_topk_auto(qn, m, valid, 10)
        ids = np.asarray([[int(e[1:]) for e, _ in h] for h in hits])
        sc = np.asarray([[s for _, s in h] for h in hits])
        if not topk_agree(ids, sc, i_p.cpu().numpy(), s_p.cpu().numpy(), TOPK_SCORE_ATOL):
            raise AssertionError(f"1M-row index answers disagree with the plain path at B={b}")
        row = time_topk(dev, m, valid, b, 10, seed, card)
        row["first_search_s"] = first_s
        row["launches_per_search"] = 1
        rows.append(row)
    REPORT["index"] = {"rows": len(idx), "dims": d, "fill_s": fill_s, "timings": rows}
    del idx, m, valid
    torch.cuda.empty_cache()
    return rows


# -- driver ----------------------------------------------------------------


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--docs", type=int, default=100_000)
    ap.add_argument("--index-rows", type=int, default=1 << 20)
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    t_start = time.perf_counter()
    dev = phase_device()
    card = REPORT["card"]
    phase_build()
    phase_kernels(dev, args.seed)
    launches, vecs = phase_main_path(dev, args.seed, args.docs)

    # each kernel timed at the shape the main path gives it
    mp = REPORT["main_path"]
    with vecs._lock:
        m, valid = vecs._device_arrays_locked()
    topk_row = time_topk(dev, m, valid, 1, 30, args.seed, card)
    attn_row = time_attention(dev, 16, 64, 4, 40, args.seed, card)
    REPORT["main_path_timings"] = {"cosine_topk": topk_row, "flash_attention": attn_row}
    del m, valid, vecs
    log(f"launches per query: cosine_topk {mp['launches_per_query']['cosine_topk']:.3f} "
        f"(per vector or hybrid search), flash_attention "
        f"{mp['launches_per_query']['flash_attention']:.4f} (per text through the encoder)")

    phase_index(dev, args.seed, args.index_rows, card)
    REPORT["total_s"] = time.perf_counter() - t_start

    kernels = [
        {"name": "cosine_topk", "route": "cuda",
         "source": "nornicdb_tpu_torch/csrc/cosine_topk.cu",
         "replaces": "nornicdb_tpu/ops/pallas_topk.py:125",
         "launches": launches["cosine_topk"],
         "max_abs_err": REPORT["topk_max_abs_err"],
         "ms": topk_row["kernel_ms"], "plain_ms": topk_row["plain_ms"],
         "bound_ms": topk_row["bound_ms"], "bound_by": topk_row["bound_by"],
         "library_ms": topk_row["library_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "nornicdb_tpu_torch/csrc/flash_attention.cu",
         "replaces": "nornicdb_tpu/ops/pallas_attention.py:131",
         "launches": launches["flash_attention"],
         "max_abs_err": REPORT["attention_max_abs_err"],
         "ms": attn_row["kernel_ms"], "plain_ms": attn_row["plain_ms"],
         "bound_ms": attn_row["bound_ms"], "bound_by": attn_row["bound_by"],
         "library_ms": attn_row["library_ms"]},
    ]
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke_report.json"), "w") as f:
        json.dump(REPORT, f, indent=1)
    log(f"total {REPORT['total_s']:.1f} s")
    log(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
