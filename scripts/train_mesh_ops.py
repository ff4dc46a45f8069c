#!/usr/bin/env python3
"""Operations a training step dispatches: the sharded encoder step
(``models/train.py:make_sharded_train_step``) against the single-device
step on the same weights and batch.

Run from the root of a checkout:

    python3 scripts/train_mesh_ops.py [--device cpu|cuda] [--layers N]
        [--dtype float32|bfloat16] [--spec DP TP SP] [--batch B] [--seq S]

Counts every ATen operation (``TorchDispatchMode``) of one step after a
warm-up step, forward, backward and AdamW, at the mini encoder's widths
(``EncoderConfig.mini()``; ``--layers`` and ``--dtype`` override its
depth and type), on a mesh of ``DP x TP x SP`` members all on
``--device``. The count depends on the shapes' structure, not on the
device; on the card each operation is at least one launch, so the count
bounds a host-bound step's launches from below. Prints one JSON line.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import os
import sys

import numpy as np


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--dtype", default="float32", choices=("float32", "bfloat16"))
    ap.add_argument("--spec", type=int, nargs=3, default=(2, 2, 2))
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from nornicdb_tpu_torch.models import train as ttr
    from nornicdb_tpu_torch.models.encoder import EncoderConfig
    from nornicdb_tpu_torch.parallel.mesh import MeshSpec, make_mesh

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = collections.Counter()

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops[str(func.overloadpacket)] += 1
            return func(*args, **(kwargs or {}))

    cfg = dataclasses.replace(EncoderConfig.mini(), dtype=getattr(torch, args.dtype))
    if args.layers is not None:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    rng = np.random.default_rng(0)
    a, p = (rng.integers(1, cfg.vocab_size, (args.batch, args.seq)) for _ in range(2))
    model, single = ttr.create_train_state(cfg, 0, device=args.device)
    members = [model.tok_embed.weight.device] * int(np.prod(args.spec))
    state, step = ttr.make_sharded_train_step(model, single, make_mesh(MeshSpec(*args.spec),
                                                                       members))
    counts = {}
    for name, run in (("sharded", lambda: step(state, a, p)),
                      ("single", lambda: ttr.contrastive_train_step(model, single, a, p))):
        run()  # the optimizer's state is made on the first step
        with Count() as c:
            run()
        counts[name] = c.ops
    print(json.dumps({
        "device": str(members[0]), "layers": cfg.num_layers, "dtype": args.dtype,
        "spec": list(args.spec), "batch": args.batch, "seq": args.seq,
        "ops": {k: sum(v.values()) for k, v in counts.items()},
        "sharded_top": counts["sharded"].most_common(6)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
