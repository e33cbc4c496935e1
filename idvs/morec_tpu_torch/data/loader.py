"""Host-side batch construction with static shapes (JAX twin:
idvs/morec_tpu/data/loader.py, copied, so the same seed gives the same
batches bit for bit).

- User sequences are padded ONCE into dense int32 matrices; per-epoch work is
  a permutation + fancy-indexing, not per-sample Python
  (reference BuildTrainDataset.__getitem__, inbatch_sasrec_e2e_text/data_utils/dataset.py:24-36).
- Every batch has the same shape (the final partial batch wraps around the
  permutation), so the kernels see one shape a run.
- Modality content (token rows) is NOT gathered on the host: the device
  keeps the catalog matrix and the train step gathers rows by id; the host
  ships (B, L+1) ids. Images travel with the batch (data/vision_loader.py).
- The order is keyed by (seed, epoch) alone, so a resumed run regenerates
  the same batches.
- Negative sampling (BCE variants) is vectorized rejection sampling keyed by
  (seed, epoch), replicating dataset.py:35-39 semantics (uniform over
  [1, item_num], resample while the draw is in the user's sequence).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Tuple

import numpy as np


def pad_user_sequences(u2seq: Dict[int, List[int]], pad_to: int
                       ) -> Tuple[np.ndarray, np.ndarray]:
    """Left-pad each user's sequence with 0 to `pad_to` items.

    Returns (seqs (N, pad_to) int32, seq_lens (N,) int32). Mirrors the
    per-sample padding in reference dataset.py:24-36 done once, densely.
    """
    n = len(u2seq)
    seqs = np.zeros((n, pad_to), dtype=np.int32)
    lens = np.zeros(n, dtype=np.int32)
    for row, uid in enumerate(sorted(u2seq.keys())):
        s = u2seq[uid]
        L = len(s)
        assert L <= pad_to, (uid, L, pad_to)
        seqs[row, pad_to - L:] = s
        lens[row] = L
    return seqs, lens


def pad_histories(hist: Dict[int, np.ndarray], width: int) -> np.ndarray:
    """(N, width) int64 matrix of the users' histories in uid order, each
    cut to ``width`` and right-padded with 0 (JAX train/runner.py
    ``_pad_histories``)."""
    out = np.zeros((len(hist), width), dtype=np.int64)
    for row, uid in enumerate(sorted(hist.keys())):
        h = hist[uid]
        out[row, :len(h)] = h[:width]
    return out


def log_mask_from_lens(lens: np.ndarray, max_seq_len: int) -> np.ndarray:
    """log_mask (N, L): [0]*(L+1-seq_len) + [1]*(seq_len-1), total length L.

    Matches reference dataset.py:27-29: positions count the L *transition*
    slots of the (L+1)-item padded sequence.
    """
    pos = np.arange(max_seq_len, dtype=np.int32)[None, :]
    head = (max_seq_len + 1 - lens)[:, None]  # number of leading zeros
    return (pos >= head).astype(np.float32)


def _epoch_perm(n: int, seed: int, epoch: int, world_pad: int) -> np.ndarray:
    """Deterministic per-epoch permutation, padded (by wrapping) to a multiple
    of world_pad so every shard/batch has full static shape.

    Replaces torch DistributedSampler.set_epoch (reference
    run.py:114,230): every rank computes the same global permutation.
    """
    rng = np.random.default_rng(np.uint64(seed) + np.uint64(epoch) * np.uint64(1_000_003))
    perm = rng.permutation(n)
    total = ((n + world_pad - 1) // world_pad) * world_pad
    if total > n:
        # wrap as many times as needed — the pad can exceed n when the
        # global batch is larger than the whole (tiny) dataset
        perm = np.tile(perm, -(-total // n))[:total]
    return perm


# rounds of redraws before sample_negatives gives up (the JAX twin's
# max_rounds default)
NEG_ROUNDS = 64


def sample_negatives(rng: np.random.Generator,
                     seqs_padded: np.ndarray,
                     item_num: int,
                     neg_per_pos: int = 1) -> np.ndarray:
    """Vectorized rejection sampling of negatives not present in the user's seq.

    seqs_padded: (B, S) the user's padded sequence (0 = pad).
    Returns (B, S-1, neg_per_pos) draws in [1, item_num] (reference
    bce_text/main-end2end/data_utils/dataset.py:35-39 semantics): a draw
    found in the row's sequence is drawn again, up to NEG_ROUNDS rounds; a
    draw that still hits after the last round is kept, as the JAX twin
    keeps it (a row whose sequence holds nearly the whole catalog).
    """
    B, S = seqs_padded.shape
    out = rng.integers(1, item_num + 1, size=(B, S - 1, neg_per_pos), dtype=np.int64)
    # Membership test, fully vectorized: flatten all rows into one sorted key
    # space by offsetting each row's values with row * (item_num + 1).
    sorted_seq = np.sort(seqs_padded.astype(np.int64), axis=1)  # (B, S)
    row_off = (np.arange(B, dtype=np.int64) * (item_num + 1))[:, None]
    flat_keys = (sorted_seq + row_off).ravel()  # globally sorted
    for _ in range(NEG_ROUNDS):
        queries = (out.reshape(B, -1) + row_off).reshape(-1)
        idx = np.searchsorted(flat_keys, queries, side="left")
        idx = np.clip(idx, 0, flat_keys.size - 1)
        hit = (flat_keys[idx] == queries).reshape(B, -1)
        if not hit.any():
            break
        redraw = rng.integers(1, item_num + 1, size=int(hit.sum()), dtype=np.int64)
        flat = out.reshape(B, -1)
        flat[hit] = redraw
        out = flat.reshape(B, S - 1, neg_per_pos)
    return out


@dataclasses.dataclass
class TrainBatcher:
    """In-batch CE batches: (ids (B, L+1), log_mask (B, L)).

    Content gathering happens on the device from the resident catalog
    matrix, so this is all the host ships per step.
    """
    seqs: np.ndarray      # (N, L+1) int32 padded
    lens: np.ndarray      # (N,)
    max_seq_len: int
    batch_size: int       # GLOBAL batch (sum over shards)
    seed: int = 12345
    # optional epoch -> permutation override (tests inject the reference
    # DistributedSampler's torch.randperm order for composed-loop parity)
    perm_fn: object = None

    def __post_init__(self):
        self.n = self.seqs.shape[0]
        self.log_mask = log_mask_from_lens(self.lens, self.max_seq_len)

    def steps_per_epoch(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        if self.perm_fn is not None:
            perm = np.asarray(self.perm_fn(epoch))
        else:
            perm = _epoch_perm(self.n, self.seed, epoch, self.batch_size)
        for i in range(0, len(perm), self.batch_size):
            idx = perm[i:i + self.batch_size]
            yield self.seqs[idx], self.log_mask[idx]


@dataclasses.dataclass
class BCETrainBatcher:
    """BCE/SASRec batches: (pos_ids (B, L+1), neg_ids (B, L+1), log_mask (B, L)).

    neg layout matches the reference interleave semantics
    (bce_text/main-end2end/data_utils/dataset.py:31-42): negatives aligned so
    neg_ids[:, :-1] are the per-position negatives and neg_ids[:, -1] = 0.
    """
    seqs: np.ndarray
    lens: np.ndarray
    max_seq_len: int
    batch_size: int
    item_num: int
    seed: int = 12345

    def __post_init__(self):
        self.n = self.seqs.shape[0]
        self.log_mask = log_mask_from_lens(self.lens, self.max_seq_len)

    def steps_per_epoch(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        perm = _epoch_perm(self.n, self.seed, epoch, self.batch_size)
        rng = np.random.default_rng(
            np.uint64(self.seed) + np.uint64(epoch) * np.uint64(7_368_787) + 1)
        for i in range(0, len(perm), self.batch_size):
            idx = perm[i:i + self.batch_size]
            pos = self.seqs[idx]
            lm = self.log_mask[idx]
            draws = sample_negatives(rng, pos, self.item_num)[:, :, 0]  # (B, S-1)
            # negatives occupy the same slots as their positive transitions:
            # [0]*mask_len + negs + [0]  (reference dataset.py:40)
            neg = np.zeros_like(pos)
            neg[:, :-1] = np.where(lm != 0, draws, 0)
            yield pos, neg, lm


@dataclasses.dataclass
class DSSMTrainBatcher:
    """DSSM pair batches: (user (B,), items (B, 1+neg_num), labels (B, 1+neg_num)).

    One sample per (user, pos_item) pair with neg_num rejection-sampled
    negatives (reference bce_text/main-end2end(DSSM)/data_utils/dataset.py:9-34).
    """
    train_pairs: np.ndarray              # (P, 2)
    user_seqs: Dict[int, List[int]]      # full per-user sequences for rejection
    item_num: int
    neg_num: int
    batch_size: int
    seed: int = 12345

    def __post_init__(self):
        self.n = self.train_pairs.shape[0]
        # Padded per-user sequences for vectorized rejection
        max_len = max(len(s) for s in self.user_seqs.values()) if self.user_seqs else 1
        uid_max = max(self.user_seqs.keys())
        self._seq_mat = np.zeros((uid_max + 1, max_len), dtype=np.int64)
        for uid, s in self.user_seqs.items():
            self._seq_mat[uid, :len(s)] = s

    def steps_per_epoch(self) -> int:
        return (self.n + self.batch_size - 1) // self.batch_size

    def epoch(self, epoch: int) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        perm = _epoch_perm(self.n, self.seed, epoch, self.batch_size)
        rng = np.random.default_rng(
            np.uint64(self.seed) + np.uint64(epoch) * np.uint64(7_368_787) + 2)
        for i in range(0, len(perm), self.batch_size):
            idx = perm[i:i + self.batch_size]
            users = self.train_pairs[idx, 0]
            pos = self.train_pairs[idx, 1]
            seqs = self._seq_mat[users]                       # (B, max_len)
            negs = sample_negatives(rng, seqs, self.item_num,
                                    neg_per_pos=self.neg_num)[:, 0, :]  # (B, neg_num)
            items = np.concatenate([pos[:, None], negs], axis=1)
            labels = np.zeros_like(items, dtype=np.float32)
            labels[:, 0] = 1.0
            yield users.astype(np.int32), items.astype(np.int32), labels


@dataclasses.dataclass
class EvalBatches:
    """Static-shape eval batches over users, order-exact.

    Reproduces SequentialDistributedSampler semantics (reference
    dataset.py:68-94): pad the user list by repeating the LAST index up to a
    multiple of (batch_size * num_shards); metrics are later truncated back to
    the true user count before the mean — aggregation is order-exact.

    Yields (ids (B, L) int32 input item ids, log_mask (B, L) float32,
            target (B,) int32, history (B, H) int64 padded with 0,
            valid (B,) bool — False for padding users).
    """
    seqs: np.ndarray          # (N, <=L+1) padded eval sequences (input+target)
    lens: np.ndarray
    max_seq_len: int
    batch_size: int
    history: np.ndarray       # (N, H) int64, 0-padded per-user history
    num_shards: int = 1

    def __post_init__(self):
        self.n = self.seqs.shape[0]
        chunk = self.batch_size * self.num_shards
        self.total = ((self.n + chunk - 1) // chunk) * chunk
        self._order = np.arange(self.total)
        self._order[self.n:] = self.n - 1  # repeat last index (dataset.py:88)

    def __iter__(self):
        L = self.max_seq_len
        S = self.seqs.shape[1]  # L+1
        for i in range(0, self.total, self.batch_size):
            idx = self._order[i:i + self.batch_size]
            rows = self.seqs[idx]          # (B, L+1): [pad..., inputs..., target]
            lens = self.lens[idx]
            # inputs = all but last real item, re-padded to length L
            # (BuildEvalDataset.__getitem__: pad_tokens length == L)
            inputs = rows[:, :-1].copy()
            # rows layout: zeros then the seq; dropping the final column keeps
            # [pad..., seq[:-1]] only when the row is fully right-aligned:
            target = rows[np.arange(len(idx)), -1]
            pos = np.arange(L, dtype=np.int32)[None, :]
            head = (L + 1 - lens)[:, None]
            lm = (pos >= head).astype(np.float32)
            valid = np.zeros(len(idx), dtype=bool)
            global_pos = i + np.arange(len(idx))
            valid[global_pos < self.n] = True
            yield (inputs.astype(np.int32), lm, target.astype(np.int32),
                   self.history[idx], valid)
