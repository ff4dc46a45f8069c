#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``nornicdb_tpu_torch``).

Run from the root of a checkout on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N] [--docs N] [--index-rows N]

Phases, in order; any failure exits non-zero:

1. Device: CUDA must be available; prints the card's name and power limit
   as ``nvidia-smi --query-gpu=name,power.limit`` gives them.
2. Build: compiles both CUDA kernels from ``nornicdb_tpu_torch/csrc``.
3. Kernel vs plain version on the card, on seeded inputs: the fused
   cosine top-k (B1) against a matmul + mask + stable top-k (D in {160,
   1024} x B in {1, 2, 3, 4, 5, 7, 8, 16, 33, 64, 65, 200, 256} x k in
   {1, 10, 30, 128, 256}; at B in {1, 4, 7, 64}: D = 33 and a misaligned
   base (the scalar or 4-byte copy variants), C = 5, an all-masked index
   and fewer valid rows than k; two calls bitwise equal at B in {1, 4, 8,
   64, 256}), and flash attention (B2) against the materializing softmax:
   f32 at S in {100, 128, 512}; bf16 at S in {1, 16, 33, 64, 100, 128,
   512} x (H, Dh) in {(4, 16), (4, 40), (16, 64)} with one row fully
   masked, and two bf16 calls bitwise equal at the ingest shape.
4. Main path through the public entry points: ``open(device="cuda")`` with
   the committed mini encoder (bf16, the default), ``store`` of seeded
   documents, ``flush`` (the embed queue must have failed no node, and the
   vector index must hold every document), 64 queries each in vector, text
   and hybrid mode; both kernels' launch counters must grow, and the vector
   answers must match the plain path (B = 64). Then a few
   ``recall(limit=100, mode="vector")`` calls (k = 300) must take the
   wide-k route and not B1, and agree with the plain path.
5. Index at deployment scale: a 1,048,576 x 1024 float32
   ``BruteForceIndex`` filled through ``add_batch`` and searched at
   the (B, k) of ``INDEX_TIMED``, through B1, checked against the plain
   path.

Timing uses CUDA events over back-to-back calls, and ``torch.profiler``
for the device time of each kernel per call: B1 by stage and its library
call (matmul + where + topk) at B in ``MAIN_TIMED_B`` on the main path's
index and ``INDEX_TIMED`` on the deployment-scale one, B2 and SDPA at
the shapes in ``ATTN_TIMED``. The second-to-last line is a JSON object with
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
BF16_FLOPS_PER_S = 989e12  # bf16 tensor cores, dense

# Tolerances. Both kernels compute in float32 and differ from their plain
# versions only in the order of float sums (sequential fmaf against cuBLAS
# and torch's softmax reductions), so:
TOPK_SCORE_ATOL = 1e-5  # |cosine| <= 1 over D <= 1024 terms
ATTN_F32_ATOL = 2e-5    # outputs are convex combinations of |v| ~ 1 values
# bf16: both sides round to bf16, and their f32 sums run in another order
# (tensor-core MMAs against cuBLAS and torch's softmax), so an output that
# lies within ~1e-6 of a rounding midpoint may land one rounding step
# apart: at most 3.9e-3 below |out| = 1, 7.8e-3 between 1 and 2. The
# check allows 4e-3 or one step of the value (attn_allowed); the report
# keeps the plain max abs error.
ATTN_BF16_ATOL = 4e-3
# The same encoder in float32 on the card and on the CPU: float sums in
# another order only.
EMBED_F32_COS_MIN = 0.99999
# The DB's bf16 encoder against the float32 one: each rounding to bf16
# keeps 8 mantissa bits, and two layers of projections round many times.
EMBED_BF16_COS_MIN = 0.9995

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


def _kernel_name(key: str) -> str:
    """A profiler kernel name without return type, namespace noise,
    template arguments or parameters."""
    import re

    if "Memset" in key:
        return "memset"
    key = re.sub(r"^void ", "", key).replace("(anonymous namespace)::", "")
    return re.split(r"[<(]", key, maxsplit=1)[0].strip()


def device_split(fn, iters: int = 10, expect: str = "") -> dict:
    """Device milliseconds per call of each kernel (and memset) that ``fn``
    launches, from a torch.profiler trace of ``iters`` calls. A trace
    that lost the kernel named ``expect`` (the profiler now and then drops
    a ctypes launch's record) is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        out = {}
        for ev in prof.key_averages():
            total_us = getattr(ev, "device_time_total", None) or getattr(ev, "cuda_time_total", 0.0)
            if total_us and ev.device_type == torch.autograd.DeviceType.CUDA:
                name = _kernel_name(ev.key)
                out[name] = out.get(name, 0.0) + total_us / iters / 1e3
        if out and any(expect.lower() in name.lower() for name in out):
            return out
    raise AssertionError(f"the profiler recorded no device time for {expect or 'fn'}: {out}")


def bound_ms(n_bytes: float, flops: float, flops_per_s: float = None):
    """(least milliseconds the card could take, which roof binds); the
    operations run at ``flops_per_s`` (float32 outside the tensor cores
    unless given)."""
    t_b, t_f = n_bytes / HBM_BYTES_PER_S, flops / (flops_per_s or F32_FLOPS_PER_S)
    return max(t_b, t_f) * 1e3, ("bytes" if t_b >= t_f else "operations")


def topk_cost(b: int, c: int, d: int, k: int):
    """Bytes (matrix, queries, mask read once; scores + ids written once)
    and float32 FLOPs of one exact top-k call."""
    return c * d * 4 + b * d * 4 + c + b * k * 8, 2.0 * b * c * d


def attn_cost(b: int, s: int, h: int, dh: int, elem: int):
    """Bytes (q, k, v read once, out written once, mask) and FLOPs."""
    return 4 * b * s * h * dh * elem + b * s, 4.0 * b * h * s * s * dh


# B1's timed query counts, k = 30 on the main path's index, and (B, k) on
# the deployment-scale one: B = 1 is what a search sends, B <= 4 the
# streaming scan, B >= 5 the register-tiled kernel (8 on the bytes side of
# the B = 40 crossover, 64 and 256 on the operations side; k = 128 at
# B = 64 takes a 32-query tile, so the matrix is read twice).
MAIN_TIMED_B = (1, 4, 8, 64)
INDEX_TIMED = ((1, 10), (4, 10), (8, 10), (64, 10), (256, 10), (64, 128))

# B2's timed shapes (B, S, H, Dh) and types: ingest through the mini
# encoder, one query embedded on the search path, the mini encoder at its
# max_len (the long-document bucket), bge-m3-like heads (the most work
# per launch, where operations come closest to bytes), and the ingest
# shape in float32 for bf16 against f32 in one call.
ATTN_TIMED = (
    ((16, 64, 4, 40), "bfloat16"),
    ((1, 16, 4, 40), "bfloat16"),
    ((16, 512, 4, 40), "bfloat16"),
    ((8, 512, 16, 64), "bfloat16"),
    ((16, 64, 4, 40), "float32"),
)


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


def check_topk(dev, rng, c, d, b, k, valid_frac=0.9, m=None, misaligned=False):
    """One B1 case: masked rows, duplicated rows (exact ties), queries
    that hit the duplicates. ``misaligned`` offsets both bases by one
    float (the scalar path). Returns the max abs score error."""
    import torch

    from nornicdb_tpu_torch.ops.similarity import cosine_topk
    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk, topk_agree

    n_dup = min(c // 4, 512)
    if m is None:  # a matrix passed in carries the same duplicates
        m = _normalized(rng, c, d)
        m[c - n_dup:] = m[:n_dup]  # exact duplicates -> exact score ties
    valid = rng.random(c) < valid_frac
    q = _normalized(rng, b, d)
    q[: b // 2] = m[rng.integers(0, n_dup, b // 2)]  # queries on duplicated rows
    if misaligned:
        qt, mt = (torch.from_numpy(np.concatenate([[0.0], x.ravel()]).astype(np.float32))
                  .to(dev)[1:].view(x.shape) for x in (q, m))
    else:
        qt, mt = (torch.from_numpy(x).to(dev) for x in (q, m))
    vt = torch.from_numpy(valid).to(dev)
    s_k, i_k = fused_cosine_topk(qt, mt, vt, k)
    s_p, i_p = cosine_topk(qt, mt, vt, k)
    torch.cuda.synchronize()
    s_k, i_k, s_p, i_p = (x.cpu().numpy() for x in (s_k, i_k, s_p, i_p))
    if (s_k.shape != (b, min(k, c)) or i_k.dtype != np.int64
            or not np.isfinite(s_k).all()):
        raise AssertionError(f"B1 bad output shape/values at C={c} D={d} B={b} k={k}")
    err = float(np.abs(s_k - s_p).max())
    if not topk_agree(i_k, s_k, i_p, s_p, TOPK_SCORE_ATOL):
        raise AssertionError(
            f"B1 disagrees with its plain version at C={c} D={d} B={b} k={k} "
            f"valid {valid_frac} misaligned {misaligned} (max score err {err:.3g})")
    return err


def check_topk_deterministic(dev, rng, c, d, b, k):
    """Two calls on the same inputs give bitwise-equal scores and ids."""
    import torch

    from nornicdb_tpu_torch.ops.topk import fused_cosine_topk

    m = torch.from_numpy(_normalized(rng, c, d)).to(dev)
    m[c // 2: c // 2 + 512] = m[:512]  # exact ties across distant blocks
    valid = torch.from_numpy(rng.random(c) < 0.9).to(dev)
    q = m[torch.arange(b, device=dev) * 7].contiguous()
    first = fused_cosine_topk(q, m, valid, k)
    second = fused_cosine_topk(q, m, valid, k)
    if not (torch.equal(first[0], second[0]) and torch.equal(first[1], second[1])):
        raise AssertionError(f"B1 is not deterministic at C={c} D={d} B={b} k={k}")


def attn_allowed(ref, dtype, atol):
    """Largest difference allowed from the plain version's output ``ref``:
    ``atol`` in float32; in bf16 also one rounding step of ``ref`` (2^-7
    of its power of two), which exceeds ``atol`` from |ref| = 1 on."""
    import torch

    if dtype != torch.bfloat16:
        return torch.full_like(ref.float(), atol)
    step = torch.exp2(torch.floor(torch.log2(ref.float().abs().clamp(min=1e-30))) - 7)
    return step.clamp(min=atol)


def check_attention(dev, rng, b, s, h, dh, dtype, atol, fully_masked=False,
                    twice=False):
    """One B2 case with ragged key lengths (the first row full). With
    ``fully_masked`` the last row masks every key, so the plain version
    gives the uniform average over its S keys; with ``twice`` two calls
    must be bitwise equal. Returns the max abs error."""
    import torch

    from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention

    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    lengths = rng.integers(1, s + 1, b)
    lengths[0] = s
    if fully_masked:
        lengths[-1] = 0
    mask = torch.from_numpy(np.arange(s)[None, :] < lengths[:, None]).to(dev)
    out = flash_attention(q, k, v, mask)
    ref = reference_attention(q, k, v, mask)
    torch.cuda.synchronize()
    what = f"B={b} S={s} H={h} Dh={dh} {dtype}"
    if out.shape != q.shape or out.dtype != dtype or not torch.isfinite(out).all():
        raise AssertionError(f"B2 bad output at {what}")
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    over = diff > attn_allowed(ref, dtype, atol)
    if over.any():
        i = int(over.flatten().nonzero()[0])
        raise AssertionError(
            f"B2 disagrees with its plain version at {what}: {int(over.sum())} outputs "
            f"over the tolerance, first {out.flatten()[i].item()} against "
            f"{ref.flatten()[i].item()}; max abs {err:.3g}")
    if fully_masked:
        uniform = v[-1].float().mean(0, keepdim=True).expand(s, h, dh).to(dtype).float()
        if ((ref[-1].float() - uniform).abs() > attn_allowed(uniform, dtype, atol)).any():
            raise AssertionError(f"B2's plain version is not uniform on a masked row at {what}")
    if twice and not torch.equal(out, flash_attention(q, k, v, mask)):
        raise AssertionError(f"B2 is not deterministic at {what}")
    return err


def phase_kernels(dev, seed):
    import torch

    rng = np.random.default_rng(seed)
    errs = []
    for d, c in ((160, 100_003), (1024, 30_011)):
        m = _normalized(rng, c, d)
        m[c - 512:] = m[:512]  # exact duplicates -> exact score ties
        for b in (1, 2, 3, 4, 5, 7, 8, 16, 33, 64, 65, 200, 256):
            for k in (1, 10, 30, 128, 256):
                errs.append(check_topk(dev, rng, c, d, b, k, m=m))
    for b in (1, 4, 7, 64):
        for k in (10, 256):
            errs.append(check_topk(dev, rng, 5000, 33, b, k))  # D % 4 != 0: scalar copies
        errs.append(check_topk(dev, rng, 5000, 160, b, 30, misaligned=True))
        errs.append(check_topk(dev, rng, 5, 160, b, 5))        # fewer rows than blocks or QB
        errs.append(check_topk(dev, rng, 5, 33, b, 3))
        errs.append(check_topk(dev, rng, 3000, 160, b, 30, valid_frac=0.0))  # all masked
        # fewer valid rows than k: the tail carries the masked score
        errs.append(check_topk(dev, rng, 300, 160, b, 256, valid_frac=0.3))
    repeat_b = (1, 4, 8, 64, 256)
    for b in repeat_b:
        check_topk_deterministic(dev, rng, 131_072, 160, b, 30)
    REPORT["topk_max_abs_err"] = max(errs)
    log(f"B1 vs plain: {len(errs)} cases agree (tie-aware), max score err "
        f"{max(errs):.3g} <= {TOPK_SCORE_ATOL}; two calls bitwise equal at B in {repeat_b}")
    errs = []
    for h, dh in ((4, 40), (16, 64)):
        for s in (100, 128, 512):
            errs.append(check_attention(dev, rng, 8, s, h, dh, torch.float32, ATTN_F32_ATOL))
    bf = [check_attention(dev, rng, 16, 64, 4, 40, torch.bfloat16, ATTN_BF16_ATOL,
                          twice=True)]  # the ingest shape
    for h, dh in ((4, 16), (4, 40), (16, 64)):
        for s in (1, 16, 33, 64, 100, 128, 512):
            bf.append(check_attention(dev, rng, 8, s, h, dh, torch.bfloat16,
                                      ATTN_BF16_ATOL, fully_masked=True))
    REPORT["attention_max_abs_err"] = max(max(errs), max(bf))
    REPORT["attention_bf16_max_abs_err"] = max(bf)
    log(f"B2 vs plain: f32 max abs {max(errs):.3g} <= {ATTN_F32_ATOL}; bf16 "
        f"{len(bf)} cases (one row fully masked in each but the first) max abs "
        f"{max(bf):.3g} (allowed: {ATTN_BF16_ATOL} or one bf16 rounding step of the value); "
        f"two bf16 calls bitwise equal at the ingest shape")


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
    # the embed queue is fail-open: a kernel fault while embedding is
    # logged and the node left without a vector, so count both here
    if db._embed_queue.failed_count:
        raise AssertionError(f"the embed queue failed {db._embed_queue.failed_count} nodes")
    t1 = time.perf_counter()
    svc = db.search  # builds BM25 + vector indexes over the stored nodes
    index_s = time.perf_counter() - t1
    if len(svc.vectors) != n_docs:
        raise AssertionError(f"the vector index holds {len(svc.vectors)} of {n_docs} documents")
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

    # embeddings on the card agree with the CPU port on a small input: two
    # explicit float32 embedders agree to float sums, and the DB's default
    # bf16 embedder agrees with them to bf16 rounding
    from nornicdb_tpu_torch.models.checkpoint import load_default_embedder

    sample = docs[:8] + queries[:8]
    f32 = [np.asarray(load_default_embedder(d, dtype=torch.float32).embed_batch(sample))
           for d in (dev, "cpu")]
    bf16 = np.asarray(db._embedder.inner.embed_batch(sample))
    if db._embedder.inner.cfg.dtype != torch.bfloat16:
        raise AssertionError("the default DB does not embed in bf16")
    for a, b, cos_min, what in ((f32[0], f32[1], EMBED_F32_COS_MIN, "f32 card vs CPU"),
                                (bf16, f32[1], EMBED_BF16_COS_MIN, "bf16 card vs f32 CPU")):
        cos = (a * b).sum(1) / np.linalg.norm(a, axis=1) / np.linalg.norm(b, axis=1)
        if cos.min() < cos_min or not np.isfinite(a).all() or a.shape != (16, 160):
            raise AssertionError(f"{what} embedding cosine {cos.min():.7f} < {cos_min}")
        log(f"  embeddings {what}: min cosine {cos.min():.7f} >= {cos_min}")

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

    # recall(limit=100) asks for k = 300 > MAX_K: the reference's XLA
    # route, counted apart from B1's launches
    before = (fused_cosine_topk.launches, fused_cosine_topk.wide_k_calls)
    wide_q = queries[:4]
    wide = [db.recall(q, limit=100, mode="vector") for q in wide_q]
    grew = (fused_cosine_topk.launches - before[0], fused_cosine_topk.wide_k_calls - before[1])
    if grew != (0, len(wide_q)):
        raise AssertionError(f"limit-100 recalls took B1 or skipped the wide-k route: {grew}")
    qw = l2_normalize(torch.tensor(np.asarray(db._embedder.embed_batch(wide_q)),
                                   dtype=torch.float32, device=dev)).contiguous()
    s_p, i_p = (x.cpu().numpy() for x in cosine_topk_auto(qw, m, valid, 300))
    ext = vecs._ids_locked()
    for row, hits in enumerate(wide):
        if len(hits) != 100:
            raise AssertionError(f"limit-100 recall returned {len(hits)} hits")
        if not topk_agree([[h["id"] for h in hits]], [[h["score"] for h in hits]],
                          [[ext[int(i)] for i in i_p[row, :100]]], [s_p[row, :100]],
                          TOPK_SCORE_ATOL):
            raise AssertionError("limit-100 recall disagrees with the plain path at k = 300")
    log(f"  recall(limit=100): {len(wide_q)} wide-k calls, 0 B1 launches, answers agree")

    def pct(xs, p):
        return float(np.percentile(np.asarray(xs), p))

    mp = {
        "docs": n_docs, "store_docs_per_s": n_docs / store_s,
        "store_s": store_s, "flush_s": flush_s, "index_build_s": index_s,
        "embed_docs_per_s_incl_store": n_docs / (store_s + flush_s),
        "capacity": vecs._capacity, "dims": vecs.dims,
        "launches": launches,
        "wide_k_calls": grew[1],
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
    stages = device_split(lambda: fused_cosine_topk(q, m, valid, k), expect="merge_kernel")
    fused_cosine_topk.launches = saved  # comparison launches do not count
    plain = time_ms(lambda: cosine_topk_auto(q, m, valid, k), iters=5)
    neg = torch.tensor(-1e30, device=dev)

    def library():
        s = torch.where(valid[None, :], torch.matmul(q, m.T), neg)
        return torch.topk(s, k, dim=1)

    lib = time_ms(library, iters=10)
    lib_split = device_split(library, expect="topk")
    n_bytes, flops = topk_cost(b, c, d, k)
    bnd, by = bound_ms(n_bytes, flops)
    row = {"C": c, "D": d, "B": b, "k": k, "kernel_ms": kernel, "plain_ms": plain,
           "library_ms": lib, "library_device_ms": sum(lib_split.values()),
           "library_split": lib_split, "bound_ms": bnd, "bound_by": by,
           "device_ms": stages, "card": card}
    log(f"B1 C={c} D={d} B={b} k={k} [{card}]: kernel_ms {kernel:.4f} device_ms "
        f"{sum(stages.values()):.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"library_device_ms {row['library_device_ms']:.4f} bound_ms {bnd:.4f} ({by}); "
        f"device ms per call by stage {json.dumps(stages)} library kernels "
        f"{json.dumps(lib_split)}")
    return row


def time_attention(dev, b, s, h, dh, dtype, seed, card):
    import torch
    import torch.nn.functional as F

    from nornicdb_tpu_torch.ops.attention import flash_attention, reference_attention

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.standard_normal((b, s, h, dh)).astype(np.float32))
               .to(dev).to(dtype) for _ in range(3))
    lengths = rng.integers(s // 4, s + 1, b)
    mask = torch.from_numpy(np.arange(s)[None, :] < lengths[:, None]).to(dev)
    saved = flash_attention.launches
    kernel = time_ms(lambda: flash_attention(q, k, v, mask), iters=50)
    split = device_split(lambda: flash_attention(q, k, v, mask), iters=20, expect="flash_")
    flash_attention.launches = saved
    plain = time_ms(lambda: reference_attention(q, k, v, mask), iters=20)
    qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
    am = mask[:, None, None, :]

    def library():
        return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)

    lib = time_ms(library, iters=50)
    lib_split = device_split(library, iters=20)
    n_bytes, flops = attn_cost(b, s, h, dh, q.element_size())
    bnd, by = bound_ms(n_bytes, flops, BF16_FLOPS_PER_S if dtype == torch.bfloat16
                       else F32_FLOPS_PER_S)
    name = str(dtype).replace("torch.", "")
    row = {"B": b, "S": s, "H": h, "Dh": dh, "dtype": name, "kernel_ms": kernel,
           "device_ms": sum(split.values()), "device_split": split,
           "plain_ms": plain, "library_ms": lib,
           "library_device_ms": sum(lib_split.values()), "library_split": lib_split,
           "bound_ms": bnd, "bound_by": by, "card": card}
    log(f"B2 B={b} S={s} H={h} Dh={dh} {name} [{card}]: kernel_ms {kernel:.4f} device_ms "
        f"{row['device_ms']:.4f} plain_ms {plain:.4f} library_ms {lib:.4f} "
        f"library_device_ms {row['library_device_ms']:.4f} bound_ms {bnd:.4f} ({by}); "
        f"kernels {json.dumps(split)} library kernels {json.dumps(lib_split)}")
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
    for b, k in INDEX_TIMED:
        queries = rng.random((b, d), dtype=np.float32) - 0.5
        before = fused_cosine_topk.launches
        t = time.perf_counter()
        hits = idx.search_batch(queries, k=k)
        first_s = time.perf_counter() - t
        if fused_cosine_topk.launches != before + 1:
            raise AssertionError("the deployment-scale index did not answer through B1")
        if len(hits) != b or any(len(h) != k for h in hits):
            raise AssertionError("index search returned the wrong number of hits")
        with idx._lock:
            m, valid = idx._device_arrays_locked()
        qn = torch.from_numpy(queries).to(dev)
        qn = qn / qn.norm(dim=1, keepdim=True)
        s_p, i_p = cosine_topk_auto(qn, m, valid, k)
        ids = np.asarray([[int(e[1:]) for e, _ in h] for h in hits])
        sc = np.asarray([[s for _, s in h] for h in hits])
        if not topk_agree(ids, sc, i_p.cpu().numpy(), s_p.cpu().numpy(), TOPK_SCORE_ATOL):
            raise AssertionError(f"1M-row index answers disagree with the plain path at B={b}")
        row = time_topk(dev, m, valid, b, k, seed, card)
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
    topk_rows = [time_topk(dev, m, valid, b, 30, args.seed, card) for b in MAIN_TIMED_B]
    topk_row = topk_rows[0]
    # the main path's encoder runs in bf16, so B2 is timed in bf16; the
    # first row is the ingest shape, the one the kernels line reports
    attn_rows = [time_attention(dev, *shape, getattr(torch, dtype), args.seed, card)
                 for shape, dtype in ATTN_TIMED]
    attn_row = attn_rows[0]
    REPORT["main_path_timings"] = {"cosine_topk": topk_rows, "flash_attention": attn_rows}
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
         "ms": topk_row["kernel_ms"], "device_ms": sum(topk_row["device_ms"].values()),
         "plain_ms": topk_row["plain_ms"],
         "bound_ms": topk_row["bound_ms"], "bound_by": topk_row["bound_by"],
         "library_ms": topk_row["library_ms"],
         "library_device_ms": topk_row["library_device_ms"]},
        {"name": "flash_attention", "route": "cuda",
         "source": "nornicdb_tpu_torch/csrc/flash_attention.cu",
         "replaces": "nornicdb_tpu/ops/pallas_attention.py:131",
         "launches": launches["flash_attention"],
         "max_abs_err": REPORT["attention_max_abs_err"],
         "ms": attn_row["kernel_ms"], "device_ms": attn_row["device_ms"],
         "plain_ms": attn_row["plain_ms"],
         "bound_ms": attn_row["bound_ms"], "bound_by": attn_row["bound_by"],
         "library_ms": attn_row["library_ms"],
         "library_device_ms": attn_row["library_device_ms"]},
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
