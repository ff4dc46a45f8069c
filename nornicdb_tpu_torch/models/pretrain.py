"""Contrastive pretraining of the mini encoder (counterpart of
``nornicdb_tpu/models/pretrain.py``).

Two word-windows of documents in one group are positives, in-batch others
negatives (InfoNCE, ``models/train.py``). The corpus is this
interpreter's standard-library docstrings plus the repo's README, SURVEY
and COMPONENTS sections, so an interpreter of another version reads
another corpus. ``build_corpus``, ``_window`` and ``make_batch`` are
copies of the reference's (Python's ``random.Random``, so their batches
are bitwise the reference's). ``train_mini`` runs the step under the
counterpart of ``optax.warmup_cosine_decay_schedule``
(``warmup_cosine_decay``, a plain function of the step whose step 0 is
0); ``save_checkpoint`` writes the flax fp16 blob the reference's
``load_checkpoint`` and the port's ``models/checkpoint.py`` both read.

CLI: ``python -m nornicdb_tpu_torch.models.pretrain [out.npz] [steps] [device]``
"""

from __future__ import annotations

import io
import math
import os
import random
import re
from typing import Dict, List, Optional, Tuple

import numpy as np

from nornicdb_tpu_torch._device import DeviceLike

# modules whose docstrings form the training corpus: stable, offline,
# real English across distinct technical topics
_CORPUS_MODULES = [
    "abc", "argparse", "array", "asyncio", "base64", "bisect", "calendar",
    "cmath", "codecs", "collections", "colorsys", "concurrent.futures",
    "configparser", "contextlib", "copy", "csv", "ctypes", "datetime",
    "decimal", "difflib", "dis", "doctest", "email", "enum", "fileinput",
    "fnmatch", "fractions", "functools", "getpass", "gettext", "glob",
    "gzip", "hashlib", "heapq", "hmac", "html", "http", "imaplib",
    "importlib", "inspect", "io", "ipaddress", "itertools", "json",
    "keyword", "linecache", "locale", "logging", "lzma", "mailbox",
    "math", "mimetypes", "multiprocessing", "netrc", "numbers",
    "operator", "os", "pathlib", "pdb", "pickle", "pickletools",
    "platform", "plistlib", "poplib", "pprint", "profile", "pstats",
    "py_compile", "queue", "quopri", "random", "re", "reprlib",
    "sched", "secrets", "selectors", "shelve", "shlex", "shutil",
    "signal", "smtplib", "socket", "socketserver", "sqlite3", "ssl",
    "stat", "statistics", "string", "stringprep", "struct", "subprocess",
    "symtable", "sysconfig", "tabnanny", "tarfile", "tempfile",
    "textwrap", "threading", "timeit", "token", "tokenize", "trace",
    "traceback", "types", "typing", "unicodedata", "unittest", "urllib",
    "uuid", "venv", "warnings", "wave", "weakref", "webbrowser",
    "xml", "zipapp", "zipfile", "zlib",
]


def build_corpus(min_words: int = 12) -> List[Tuple[str, str]]:
    """(group, text) documents: stdlib module + member (class/function)
    docstrings + repo doc sections.

    The GROUP is the retrieval-relevant unit: all docstrings of one
    stdlib module are about one topic, exactly the granularity search
    eval groups documents at. Contrastive pairs drawn from two DIFFERENT
    documents of the same group (make_batch) teach topic-level
    clustering — same-document windows alone only teach document
    identity, which is why the round-3 recipe's recall plateaued at the
    lexical baseline. Repo doc sections cover many topics per file, so
    each section is its own group (same-doc windows)."""
    docs: List[Tuple[str, str]] = []
    seen = set()

    def take(group: str, text: Optional[str]) -> None:
        text = (text or "").strip()
        if len(text.split()) >= min_words and text[:80] not in seen:
            seen.add(text[:80])
            docs.append((group, text))

    for name in _CORPUS_MODULES:
        try:
            import importlib

            mod = importlib.import_module(name)
        except Exception:
            continue
        group = name.split(".")[0]
        take(group, mod.__doc__)
        for member in vars(mod).values():
            try:
                take(group, getattr(member, "__doc__", None))
                if isinstance(member, type):
                    for sub in vars(member).values():
                        take(group, getattr(sub, "__doc__", None))
            except Exception:
                continue
    repo = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    for fname in ("README.md", "SURVEY.md", "COMPONENTS.md"):
        path = os.path.join(repo, fname)
        if os.path.exists(path):
            with io.open(path, encoding="utf-8") as f:
                text = f.read()
            # split large docs into section-sized documents
            for si, part in enumerate(re.split(r"\n#+ ", text)):
                if len(part.split()) >= 25:
                    docs.append((f"{fname}#{si}", part))
    return docs


def _window(words: List[str], rng: random.Random,
            lo: int, hi: int, drop: float) -> str:
    n = len(words)
    w = rng.randint(lo, hi)
    start = rng.randint(0, max(0, n - w))
    win = [t for t in words[start: start + w] if rng.random() > drop]
    return " ".join(win) if win else words[start]


def make_batch(
    groups: Dict[str, List[List[str]]],
    group_names: List[str],
    tokenizer,
    rng: random.Random,
    batch: int,
    seq_len: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """One (anchor, positive) pair per DISTINCT group.

    - anchor: short (4-14 word) heavy-dropout window — query-shaped;
    - positive: longer window from a DIFFERENT document of the same
      group when the group has several (topic-level positive), else
      from the same document (identity-level fallback);
    - one pair per group per batch, so in-batch negatives are never
      secretly same-topic (same-group negatives would push the very
      structure we want apart)."""
    picks = rng.sample(group_names, min(batch, len(group_names)))
    a = np.zeros((len(picks), seq_len), np.int32)
    p = np.zeros((len(picks), seq_len), np.int32)
    for row, g in enumerate(picks):
        members = groups[g]
        d1 = rng.randrange(len(members))
        if len(members) > 1:  # topic-level positive: a DIFFERENT doc
            d2 = rng.randrange(len(members) - 1)
            if d2 >= d1:
                d2 += 1
        else:
            d2 = d1  # singleton group: identity-level fallback
        wa = _window(members[d1], rng, 4, 14, drop=0.3)
        wp = _window(members[d2], rng, 16, 48, drop=0.1)
        for arr, text in ((a, wa), (p, wp)):
            ids = tokenizer.encode(text, max_len=seq_len)
            arr[row, : len(ids)] = ids
    return a, p


def warmup_cosine_decay(step: int, init_value: float, peak_value: float,
                        warmup_steps: int, decay_steps: int,
                        end_value: float = 0.0) -> float:
    """``optax.warmup_cosine_decay_schedule(...)(step)``: linear from
    ``init_value`` to ``peak_value`` over ``warmup_steps``, then cosine
    decay to ``end_value`` by ``decay_steps`` (which includes the warmup),
    constant after."""
    if warmup_steps > 0 and step < warmup_steps:
        return init_value + (peak_value - init_value) * step / warmup_steps
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps
    if not span > 0:
        raise ValueError(f"the cosine decay needs positive steps, got {span}")
    t = min(step - max(warmup_steps, 0), span)
    cosine = 0.5 * (1 + math.cos(math.pi * t / span))
    return peak_value * ((1 - alpha) * cosine + alpha)


def train_mini(
    steps: int = 3000,
    batch: int = 128,
    seq_len: int = 64,
    learning_rate: float = 3e-4,
    seed: int = 0,
    log_every: int = 200,
    eval_hook=None,
    device: DeviceLike = None,
    params=None,
    losses: Optional[List[float]] = None,
):
    """Train the mini encoder; returns (cfg, state_dict, final_loss).

    ``eval_hook(step, model)`` (optional) is called every ``log_every``
    steps. ``params`` (a ``state_dict``) replaces the generator's initial
    weights; ``losses``, when given, receives every step's loss."""
    import functools

    from nornicdb_tpu_torch.embed.tokenizer import HashTokenizer
    from nornicdb_tpu_torch.models.encoder import EncoderConfig
    from nornicdb_tpu_torch.models.train import (
        contrastive_train_step,
        create_train_state,
    )

    cfg = EncoderConfig.mini()
    tokenizer = HashTokenizer(cfg.vocab_size)
    groups: Dict[str, List[List[str]]] = {}
    for g, text in build_corpus():
        groups.setdefault(g, []).append(text.split())
    group_names = sorted(groups)
    batch = min(batch, len(group_names))
    rng = random.Random(seed)
    schedule = functools.partial(
        warmup_cosine_decay, init_value=0.0, peak_value=learning_rate,
        warmup_steps=min(100, steps // 10), decay_steps=steps,
        end_value=learning_rate * 0.03)
    model, state = create_train_state(cfg, seed, learning_rate=schedule,
                                      seq_len=seq_len, device=device, params=params)
    loss = float("nan")
    for step in range(steps):
        a, p = make_batch(groups, group_names, tokenizer, rng, batch, seq_len)
        state, loss_t = contrastive_train_step(model, state, a, p)
        loss = float(loss_t)
        if losses is not None:
            losses.append(loss)
        if log_every and (step + 1) % log_every == 0:
            print(f"step {step + 1}/{steps} loss {loss:.4f}", flush=True)
            if eval_hook is not None:
                eval_hook(step + 1, model)
    return cfg, model.state_dict(), loss


# -- checkpoint io ---------------------------------------------------------


def save_checkpoint(path: str, cfg, params) -> None:
    """The reference's format: fp16 flax-serialized params + the config
    fields that shape them. ``params`` is the port's ``Encoder``
    ``state_dict``."""
    from nornicdb_tpu_torch.models.checkpoint import packb
    from nornicdb_tpu_torch.models.weights import params_to_jax

    def half(tree):
        if isinstance(tree, dict):
            return {k: half(v) for k, v in tree.items()}
        return np.asarray(tree, np.float16)

    blob = packb(half(params_to_jax(params, cfg.num_heads)))
    np.savez_compressed(
        path,
        params=np.frombuffer(blob, dtype=np.uint8),
        meta=np.asarray([
            cfg.vocab_size, cfg.hidden_size, cfg.num_layers,
            cfg.num_heads, cfg.mlp_dim, cfg.max_len,
        ], dtype=np.int64),
    )


def main() -> None:  # pragma: no cover
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else "encoder_mini.npz"
    steps = int(sys.argv[2]) if len(sys.argv) > 2 else 400
    device = sys.argv[3] if len(sys.argv) > 3 else None
    cfg, params, loss = train_mini(steps=steps, device=device)
    save_checkpoint(out, cfg, params)
    size = os.path.getsize(out) / 1e6
    print(f"saved {out} ({size:.2f} MB, final loss {loss:.4f})")


if __name__ == "__main__":  # pragma: no cover
    main()
