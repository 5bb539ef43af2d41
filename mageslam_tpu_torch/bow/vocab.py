"""Online bag-of-binary-words: vocabulary training + image signatures.

Port of ``mageslam_tpu/bow/vocab.py``: a 2-level k-majority tree (6 x 6
leaves) trained from the pooled first frames, tf-idf weights, L1
signatures.  The centroid seeds are the only random draw:
``train_vocabulary`` draws them from a ``torch.Generator``,
``train_vocabulary_sampled`` through a sampler (``solvers/sampling.py``),
and ``train_vocabulary_from_samples`` is deterministic given them.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from mageslam_tpu_torch.ops.matching import hamming_matrix, popcount32
from mageslam_tpu_torch.solvers import sampling

BRANCH = 6
LEVELS = 2
NUM_LEAVES = BRANCH ** LEVELS


class Vocabulary(NamedTuple):
    l1_desc: torch.Tensor    # (B, 8) int32
    leaf_desc: torch.Tensor  # (B, B, 8) int32
    idf: torch.Tensor        # (NUM_LEAVES,)
    trained: torch.Tensor    # bool scalar


def empty_vocabulary(device=None) -> Vocabulary:
    return Vocabulary(
        l1_desc=torch.zeros((BRANCH, 8), dtype=torch.int32, device=device),
        leaf_desc=torch.zeros((BRANCH, BRANCH, 8), dtype=torch.int32,
                              device=device),
        idf=torch.ones(NUM_LEAVES, dtype=torch.float32, device=device),
        trained=torch.zeros((), dtype=torch.bool, device=device))


def _unpack_bits(desc: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int32, device=desc.device)
    bits = (desc[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], 256).to(torch.float32)


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    shifts = torch.arange(32, dtype=torch.int64, device=bits.device)
    v = (bits.to(torch.int64).reshape(bits.shape[0], 8, 32) << shifts).sum(-1)
    return torch.where(v >= 2 ** 31, v - 2 ** 32, v).to(torch.int32)


def _k_majority(desc, valid, init_idx, iters: int):
    """Fixed-iteration k-majority from seed indices; returns (centroids,
    assignment)."""
    k = init_idx.shape[0]
    cents = desc[init_idx]
    bits = _unpack_bits(desc)
    vf = valid.to(torch.float32)[:, None]
    for _ in range(iters):
        d = hamming_matrix(desc, cents)
        d = torch.where(valid[:, None], d, torch.full_like(d, 1 << 20))
        onehot = torch.nn.functional.one_hot(torch.argmin(d, 1), k) \
            .to(torch.float32) * vf
        counts = onehot.sum(0)
        mean_bits = (onehot.T @ bits) / torch.clamp(counts[:, None], min=1.0)
        new = _pack_bits(mean_bits > 0.5)
        cents = torch.where((counts > 0)[:, None], new, cents)
    d = hamming_matrix(desc, cents)
    d = torch.where(valid[:, None], d, torch.full_like(d, 1 << 20))
    return cents, torch.argmin(d, 1).to(torch.int32)


def train_vocabulary_from_samples(desc, valid, init_idx,
                                  iters: int = 12) -> Vocabulary:
    """``init_idx``: (1 + BRANCH, BRANCH) centroid seeds — row 0 for level
    1, row c + 1 for the sub-tree of level-1 cluster c (drawn with weights
    ``valid & (assign == c)``, as ``train_vocabulary`` does)."""
    l1, assign1 = _k_majority(desc, valid, init_idx[0], iters)
    leaves = []
    for c in range(BRANCH):
        mask = valid & (assign1 == c)
        leaves.append(_k_majority(desc, mask, init_idx[1 + c], iters)[0])
    vocab = Vocabulary(l1, torch.stack(leaves),
                       torch.ones(NUM_LEAVES, dtype=torch.float32,
                                  device=desc.device),
                       torch.ones((), dtype=torch.bool, device=desc.device))
    lv = quantize(vocab, desc)
    counts = torch.zeros(NUM_LEAVES, dtype=torch.float32, device=desc.device)
    counts = counts.index_add(0, lv.long(), valid.to(torch.float32))
    n_total = torch.clamp(valid.sum(), min=1).to(torch.float32)
    idf = torch.clamp(torch.log(n_total / (1.0 + counts)), min=0.0)
    return vocab._replace(idf=idf)


def train_vocabulary(gen: torch.Generator, desc, valid,
                     iters: int = 12) -> Vocabulary:
    """``train_vocabulary_sampled`` drawing from ``gen``."""
    return train_vocabulary_sampled(sampling.generator_sampler(gen), desc,
                                    valid, iters)


def train_vocabulary_sampled(sampler, desc, valid,
                             iters: int = 12) -> Vocabulary:
    """Draw level-1 seeds, cluster, then draw each sub-tree's seeds from
    its own cluster (the JAX sampling weights) and cluster again.  Every
    draw is one ``sampler(p, 1, BRANCH)`` call (``solvers/sampling.py``):
    the level-1 seeds first, then one per level-1 cluster in order."""
    p = valid.to(torch.float32) / torch.clamp(valid.to(torch.float32).sum(),
                                              min=1.0)
    seed1 = sampler(p, 1, BRANCH)[0]
    _, assign1 = _k_majority(desc, valid, seed1, iters)
    rows = [seed1]
    for c in range(BRANCH):
        mask = (valid & (assign1 == c)).to(torch.float32)
        pc = mask / torch.clamp(mask.sum(), min=1.0)
        rows.append(sampler(pc, 1, BRANCH)[0])
    return train_vocabulary_from_samples(desc, valid, torch.stack(rows),
                                         iters)


def quantize(vocab: Vocabulary, desc: torch.Tensor) -> torch.Tensor:
    """(N, 8) -> (N,) leaf ids by 2-level traversal."""
    a1 = torch.argmin(hamming_matrix(desc, vocab.l1_desc), 1)
    sub = vocab.leaf_desc[a1]                              # (N, B, 8)
    d2 = popcount32(torch.bitwise_xor(desc[:, None, :], sub)).sum(-1)
    a2 = torch.argmin(d2, 1)
    return (a1 * BRANCH + a2).to(torch.int32)


def signature(vocab: Vocabulary, desc, valid) -> torch.Tensor:
    """tf-idf L1-normalized bag-of-words vector (NUM_LEAVES,)."""
    lv = quantize(vocab, desc)
    tf = torch.zeros(NUM_LEAVES, dtype=torch.float32, device=desc.device)
    tf = tf.index_add(0, lv.long(), valid.to(torch.float32))
    v = tf * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v)), min=1e-9)


def signatures(vocab: Vocabulary, desc, valid) -> torch.Tensor:
    """Batched ``signature`` over a leading keyframe dimension."""
    Kn, F = valid.shape
    lv = quantize(vocab, desc.reshape(Kn * F, 8)).reshape(Kn, F).long()
    tf = torch.zeros((Kn, NUM_LEAVES), dtype=torch.float32,
                     device=desc.device)
    tf.scatter_add_(1, lv, valid.to(torch.float32))
    v = tf * vocab.idf
    return v / torch.clamp(torch.sum(torch.abs(v), -1, keepdim=True),
                           min=1e-9)


def similarity(sig_a: torch.Tensor, sigs: torch.Tensor) -> torch.Tensor:
    """L1 BoW score in [0, 1]: 1 - 0.5 * |a - b|_1 against each row of
    ``sigs`` (K, NUM_LEAVES)."""
    return 1.0 - 0.5 * torch.sum(torch.abs(sig_a[None, :] - sigs), -1)
