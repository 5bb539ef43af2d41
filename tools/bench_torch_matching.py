#!/usr/bin/env python3
"""Dense Hamming matching against a simulated BoW direct index, on one
NVIDIA GPU.

    python3 tools/bench_torch_matching.py [--sizes 512 1024] [--cpu]

The counterpart of ``tools/bench_matching.py`` for ``mageslam_tpu_torch``.
The reference matches through a BoW direct index (FeatureMatcher.h:21-63
IndexedMatch: only descriptors quantized to the same vocabulary node are
compared).  The port matches densely: ``ops/matching.match`` computes the
whole (N, M) XOR + popcount matrix with no data-dependent control flow.
For each N = M this times the dense match and a node-masked match
(descriptors quantized to 64 random nodes, cross-node pairs masked: the
best case for an index, its arithmetic savings without the ragged gathers
a real bucketed layout pays).  Random uint32 descriptors from
``default_rng(0)``, as the JAX tool draws them.  Each: a warm call, then
50 calls between two device syncs (host clock) and two CUDA events.

The tool measures the card: without one it exits with code 2; ``--cpu``
asks for the CPU (its numbers are the CPU's, and are labelled so).
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

ITERS = 50
NODES = 64


def problem(n: int, rng, device=None):
    """Descriptors and validity of two sets of ``n``, and each one's node,
    drawn in the JAX tool's order (descriptor words as int32 bits)."""
    import torch

    def words():
        return torch.as_tensor(rng.integers(0, 2**32, (n, 8),
                                            dtype=np.uint32).view(np.int32),
                               device=device)

    da, db = words(), words()
    ones = torch.ones(n, dtype=torch.bool, device=device)
    return da, db, ones, ones.clone()


def draw_nodes(n: int, rng, device=None):
    import torch
    return (torch.as_tensor(rng.integers(0, NODES, n), device=device),
            torch.as_tensor(rng.integers(0, NODES, n), device=device))


def dense(da, db, va, vb):
    from mageslam_tpu_torch.ops import matching
    return matching.match(da, db, va, vb)


def node_masked(da, db, va, vb, na, nb, max_distance: int = 50):
    """The simulated direct index: pairs in different nodes (or invalid)
    are masked to ``BIG``; the best candidate within ``max_distance``."""
    import torch
    from mageslam_tpu_torch.ops import matching
    d = matching.hamming_matrix(da, db)
    same = na[:, None] == nb[None, :]
    d = torch.where(same & va[:, None] & vb[None, :], d,
                    torch.full_like(d, matching.BIG))
    best, _, idx = matching._top2_min(d)
    return torch.where(best <= max_distance, idx, torch.full_like(idx, -1))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sizes", type=int, nargs="+", default=[512, 1024])
    ap.add_argument("--cpu", action="store_true",
                    help="measure the CPU instead of the card")
    args = ap.parse_args(argv)
    import torch
    if not args.cpu and not torch.cuda.is_available():
        print("bench_torch_matching: no CUDA device (--cpu measures the "
              "CPU)", file=sys.stderr)
        return 2
    cuda = not args.cpu
    device = "cuda" if cuda else "cpu"
    from bench_torch import gpu_line, time_calls
    if cuda:
        print(f"device: {gpu_line()}")
    else:
        print(f"device: cpu ({torch.get_num_threads()} threads)")
    rng = np.random.default_rng(0)
    for n in args.sizes:
        da, db, va, vb = problem(n, rng, device)
        host, ev = time_calls(lambda: dense(da, db, va, vb), ITERS, cuda)
        ms = ev if cuda else host
        print(f"dense match N=M={n}: {host:.3f} ms host"
              + (f", {ev:.3f} ms by events" if cuda else "")
              + f" ({n * n * 8 / ms / 1e6:.1f} G popcount-words/s)",
              flush=True)
        na, nb = draw_nodes(n, rng, device)
        host2, ev2 = time_calls(
            lambda: node_masked(da, db, va, vb, na, nb), ITERS, cuda)
        ms2 = ev2 if cuda else host2
        print(f"node-masked match N=M={n}: {host2:.3f} ms host"
              + (f", {ev2:.3f} ms by events" if cuda else "")
              + f" (masking adds {100 * (ms2 - ms) / ms:+.0f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
