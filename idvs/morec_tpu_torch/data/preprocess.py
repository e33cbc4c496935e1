"""Host-side dataset preprocessing, numpy (JAX twin: idvs/morec_tpu/data/
preprocess.py, copied).

Reproduces the reference preprocessing semantics exactly:
- item TSV readers             (reference inbatch_sasrec_e2e_text/data_utils/preprocess.py:84-128)
- behavior reader: min-len filter, [-(max_seq_len+3):] truncation, dense
  re-iding of surviving items, leave-one-out split, per-user histories,
  popularity table with sentinel pop[0]=1
                               (reference preprocess.py:5-81)
- DSSM pair reader: (user, item) pairs, users ided from 1
                               (reference bce_text/main-end2end(DSSM)/
                                data_utils/preprocess.py:5-81)
- tokenized catalog matrices packed [ids || attention_mask] side by side
                               (reference preprocess.py:131-172, run.py:88-98)
- vision image manifest -> record-store keys
                               (reference inbatch_sasrec_e2e_vision/data_utils/preprocess.py:88-101)
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass
class BehaviorData:
    """Everything read_behaviors produces, as plain numpy/dicts."""
    item_num: int
    item_id_to_dic: Dict[int, object]          # new id -> item content/dict
    users_train: Dict[int, List[int]]
    users_valid: Dict[int, List[int]]
    users_test: Dict[int, List[int]]
    users_history_for_valid: Dict[int, np.ndarray]
    users_history_for_test: Dict[int, np.ndarray]
    item_name_to_id: Dict[str, int]
    pop_prob_list: np.ndarray                  # (item_num+1,), pop[0]=1 sentinel


def read_items_text(news_path: str):
    """ID-mode item reader: name -> dense id (reference preprocess.py:84-98)."""
    content_of = {}
    name_of = {}
    id_of = {}
    next_id = 1
    with open(news_path, "r") as f:
        for line in f:
            fields = line.strip("\n").split("\t")
            name = fields[0]
            id_of[name] = next_id
            content_of[next_id] = name
            name_of[next_id] = name
            next_id += 1
    # reference appends a mask sentence at the next free id (preprocess.py:97)
    content_of[next_id] = "this is a mask sentence"
    return content_of, id_of, name_of


def read_items_tokenized(news_path: str, cfg, tokenizer):
    """Tokenize item text attributes to fixed length (reference preprocess.py:101-128).

    ``tokenizer`` is any callable with the HF tokenizer's call signature
    (text, max_length=, padding="max_length", truncation=True) returning
    ``input_ids`` and ``attention_mask``; tokenization stays on the host.
    """
    content_of = {}
    name_of = {}
    id_of = {}
    next_id = 1
    with open(news_path, "r") as f:
        for line in f:
            fields = line.strip("\n").split("\t")
            name, title, abstract = fields[0], fields[1], fields[2]
            tok = {}
            if "title" in cfg.news_attributes:
                tok["title"] = tokenizer(title.lower(), max_length=cfg.num_words_title,
                                         padding="max_length", truncation=True)
            if "abstract" in cfg.news_attributes:
                tok["abstract"] = tokenizer(abstract.lower(), max_length=cfg.num_words_abstract,
                                            padding="max_length", truncation=True)
            if "body" in cfg.news_attributes:
                body = fields[3] if len(fields) > 3 else ""
                tok["body"] = tokenizer(body.lower()[:2000], max_length=cfg.num_words_body,
                                        padding="max_length", truncation=True)
            id_of[name] = next_id
            name_of[next_id] = name
            content_of[next_id] = tok
            next_id += 1
    return content_of, id_of, name_of


def read_image_manifest(images_path: str) -> Tuple[dict, dict, dict]:
    """Vision manifest: item name 'v123' -> store key b'123'.

    Reference inbatch_sasrec_e2e_vision/data_utils/preprocess.py:88-101.
    """
    key_of = {}
    id_of = {}
    name_of = {}
    next_id = 1
    with open(images_path, "r") as f:
        for line in f:
            fields = line.strip("\n").split("\t")
            name = fields[0]
            id_of[name] = next_id
            name_of[next_id] = name
            # int round-trip like the reference ('v007' -> b'7', not b'007'):
            # preprocess.py:99 int(name.replace('v', '')) — store keys must
            # match a reference-built LMDB byte for byte
            key_of[next_id] = str(int(name.replace("v", ""))).encode("ascii")
            next_id += 1
    return key_of, id_of, name_of


def _read_user_sequences(behaviors_path: str, id_of: dict,
                         min_seq_len: int, max_seq_len: int):
    """Shared first pass over the behavior TSV.

    Reference semantics (preprocess.py:10-24): drop users shorter than
    min_seq_len, keep only the LAST max_seq_len+3 interactions, and count
    every surviving interaction per raw item id. Returns
    (per-user raw-id sequences in file order, raw interaction counts,
     total surviving interactions).
    """
    n_raw_items = len(id_of)
    raw_counts = np.zeros(n_raw_items + 1, dtype=np.int64)
    raw_seqs: Dict[str, List[int]] = {}
    n_pairs = 0
    with open(behaviors_path, "r") as f:
        for line in f:
            fields = line.strip("\n").split("\t")
            user_name, clicked = fields[0], fields[1].split(" ")
            if len(clicked) < min_seq_len:
                continue
            clicked = clicked[-(max_seq_len + 3):]
            seq = [id_of[name] for name in clicked]
            raw_seqs[user_name] = seq
            for rid in seq:
                raw_counts[rid] += 1
                n_pairs += 1
    return raw_seqs, raw_counts, n_pairs


def _densify_items(raw_counts: np.ndarray, raw_content_of: dict,
                   raw_name_of: dict = None):
    """Drop zero-count items and re-id survivors densely from 1, preserving
    the ORIGINAL id order (reference preprocess.py:26-38). Returns
    (raw->dense map, dense content dict, dense name->id dict or None)."""
    dense_of: Dict[int, int] = {}
    content_of: Dict[int, object] = {}
    id_of_name = {} if raw_name_of is not None else None
    dense = 1
    for rid in range(1, len(raw_counts)):
        if raw_counts[rid] != 0:
            dense_of[rid] = dense
            content_of[dense] = raw_content_of[rid]
            if raw_name_of is not None:
                id_of_name[raw_name_of[rid]] = dense
            dense += 1
    return dense_of, content_of, id_of_name


def read_behaviors(behaviors_path: str,
                   before_item_id_to_dic: dict,
                   before_item_name_to_id: dict,
                   before_item_id_to_name: dict,
                   max_seq_len: int,
                   min_seq_len: int,
                   log=None) -> BehaviorData:
    """Reference preprocess.py:5-81, numpy edition. Invariants preserved:

    - sequences shorter than min_seq_len dropped
    - truncation keeps the LAST max_seq_len+3 interactions
    - items with zero post-filter count are removed; survivors densely re-ided
      in ORIGINAL id order starting at 1
    - leave-one-out: train = seq[:-2], valid = seq[-(L+2):-1], test = seq[-(L+1):]
    - histories: valid-history = train part, test-history = seq[:-1]
    - pop_prob = train_counts^1.0 normalized over ids 1..item_num, sentinel
      pop[0] = 1 so log(pop[0]) = 0 for padding
    """
    raw_seqs, raw_counts, n_pairs = _read_user_sequences(
        behaviors_path, before_item_name_to_id, min_seq_len, max_seq_len)
    if log:
        log.info("##### pairs_num {}".format(n_pairs))

    dense_of, content_of, id_of_name = _densify_items(
        raw_counts, before_item_id_to_dic, before_item_id_to_name)
    item_num = len(dense_of)

    users_train, users_valid, users_test = {}, {}, {}
    users_history_for_valid, users_history_for_test = {}, {}
    train_item_counts = np.zeros(item_num + 1, dtype=np.int64)
    for uid, raw_seq in enumerate(raw_seqs.values()):
        seq = [dense_of[rid] for rid in raw_seq]
        train = seq[:-2]
        users_train[uid] = train
        users_valid[uid] = seq[-(max_seq_len + 2):-1]
        users_test[uid] = seq[-(max_seq_len + 1):]
        for i in train:
            train_item_counts[i] += 1
        users_history_for_valid[uid] = np.asarray(train, dtype=np.int64)
        users_history_for_test[uid] = np.asarray(seq[:-1], dtype=np.int64)

    # popularity^1.0 over dense ids 1..item_num, index-0 sentinel = 1.0
    pop_body = np.power(train_item_counts.astype(np.float64), 1.0)[1:item_num + 1]
    pop_body = pop_body / pop_body.sum()
    pop_prob_list = np.concatenate([[1.0], pop_body]).astype(np.float64)

    return BehaviorData(
        item_num=item_num,
        item_id_to_dic=content_of,
        users_train=users_train,
        users_valid=users_valid,
        users_test=users_test,
        users_history_for_valid=users_history_for_valid,
        users_history_for_test=users_history_for_test,
        item_name_to_id=id_of_name,
        pop_prob_list=pop_prob_list,
    )


@dataclasses.dataclass
class PairBehaviorData:
    """DSSM pairwise splits (reference bce_text/main-end2end(DSSM)/data_utils/preprocess.py:5-81)."""
    user_num: int
    item_num: int
    item_id_to_content: Dict[int, object]
    users_train: Dict[int, List[int]]
    users_valid: Dict[int, List[int]]
    train_pairs: np.ndarray    # (P, 2) [user, item]
    valid_pairs: np.ndarray
    test_pairs: np.ndarray
    users_history_for_valid: Dict[int, np.ndarray]
    users_history_for_test: Dict[int, np.ndarray]


def read_behaviors_pairs(behaviors_path: str,
                         before_item_id_to_dic: dict,
                         before_item_name_to_id: dict,
                         min_seq_len: int,
                         max_seq_len: int,
                         log=None) -> PairBehaviorData:
    """DSSM variant: (user, item) interaction pairs; users ided from 1."""
    raw_seqs, raw_counts, _ = _read_user_sequences(
        behaviors_path, before_item_name_to_id, min_seq_len, max_seq_len)

    dense_of, content_of, _ = _densify_items(raw_counts, before_item_id_to_dic)
    item_num = len(dense_of)

    users_train, users_valid = {}, {}
    users_history_for_valid, users_history_for_test = {}, {}
    train_pairs, valid_pairs, test_pairs = [], [], []
    for uid, raw_seq in enumerate(raw_seqs.values(), start=1):
        seq = [dense_of[rid] for rid in raw_seq]
        train = seq[:-2]
        valid = seq[:-1]
        users_train[uid] = train
        users_valid[uid] = valid
        users_history_for_valid[uid] = np.asarray(train, dtype=np.int64)
        users_history_for_test[uid] = np.asarray(valid, dtype=np.int64)
        for i in train:
            train_pairs.append((uid, i))
        valid_pairs.append((uid, valid[-1]))
        test_pairs.append((uid, seq[-1]))

    return PairBehaviorData(
        user_num=len(raw_seqs),
        item_num=item_num,
        item_id_to_content=content_of,
        users_train=users_train,
        users_valid=users_valid,
        train_pairs=np.asarray(train_pairs, dtype=np.int64),
        valid_pairs=np.asarray(valid_pairs, dtype=np.int64),
        test_pairs=np.asarray(test_pairs, dtype=np.int64),
        users_history_for_valid=users_history_for_valid,
        users_history_for_test=users_history_for_test,
    )


def build_doc_matrix(item_id_to_dic: Dict[int, dict], cfg) -> np.ndarray:
    """Pack tokenized attributes into one (item_num+1, sum(2*L_attr)) int32 matrix.

    Layout per attribute: [input_ids || attention_mask] side by side, attributes
    concatenated in (title, abstract, body) order — identical to the reference's
    get_doc_input_bert + np.concatenate (preprocess.py:131-172, run.py:88-98).
    Row 0 is the all-zero padding item.
    """
    item_num = len(item_id_to_dic) + 1
    blocks = []
    for attr, nwords in (("title", cfg.num_words_title),
                         ("abstract", cfg.num_words_abstract),
                         ("body", cfg.num_words_body)):
        if attr not in cfg.news_attributes:
            continue
        ids = np.zeros((item_num, nwords), dtype=np.int32)
        att = np.zeros((item_num, nwords), dtype=np.int32)
        for item_id in range(1, item_num):
            tok = item_id_to_dic[item_id][attr]
            ids[item_id] = tok["input_ids"]
            att[item_id] = tok["attention_mask"]
        blocks.extend([ids, att])
    return np.concatenate(blocks, axis=1)
