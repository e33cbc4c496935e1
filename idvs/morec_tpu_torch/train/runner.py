"""Training/test orchestrator (JAX twin: idvs/morec_tpu/train/runner.py), the
reference's run.py / run_test.py (inbatch_sasrec_e2e_text/run.py:26-352) as
one config-driven entry point, for every item tower (``id``, text and
vision ``modal``, ID+modality fusion ``modal_id_add`` / ``modal_id_cat``)
and both stages: the in-batch CE and BCE with sampled negatives under
SASRec (``TrainBatcher``, ``BCETrainBatcher``), and DSSM
(``DSSMTrainBatcher`` over the (user, item) pairs of
``read_behaviors_pairs``, evaluated on each user's (user, target) pair).
The two-stage towers first run the frozen encoder once over the catalog
(``_encode_catalog``), then train a head on that float32 cache with the
encoder dropped (JAX runner.py:129-203).

Flow (parity with run.py):
  data read -> batcher -> model + optimizer -> [resume] ->
  epoch loop { train steps, eval, save-best, early stop } -> final report

On one device, the card unless the caller names another (``on_device``);
under a process group (``parallel/mesh.py``) every rank takes its rows of
each global batch (``host_rows``), the step averages the gradients, every
rank evaluates every user, and rank 0 alone logs and writes checkpoints.
The host builds the next batch (ids, dedup packing, images) on a worker
thread while the device runs the current step (``Prefetcher``).

Test mode evaluates the test split and, with ``cold_behaviors``, the cold
and new-item users (``run_special_eval``, train/special_eval.py; JAX
runner.py:582-667); ``accumulation_step`` k > 1 updates once every k
micro-steps on their mean gradient (train/state.py ``accumulate``, the
JAX runner's optax.MultiSteps). Raising ``NotImplementedError`` with the
reason: DSSM over a two-stage tower, which is no reference variant and
which the JAX runner's DSSM data cannot feed (it builds no cache); DSSM
with a cold file (the JAX special eval scores SASRec users); new items of
a two-stage tower (its cache holds none; the JAX runner fails there too).
``steps_per_dispatch`` runs that many single steps and reads their losses
together (the JAX package's one-dispatch scan makes the same updates).
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Any, Dict, Optional

import numpy as np
import torch

from ..config import Config
from ..data.loader import (BCETrainBatcher, DSSMTrainBatcher, EvalBatches,
                           TrainBatcher, pad_histories, pad_user_sequences)
from ..data.preprocess import (BehaviorData, build_doc_matrix,
                               read_behaviors, read_behaviors_pairs,
                               read_image_manifest, read_items_text,
                               read_items_tokenized)
from ..models.layers import init_parameters, on_device
from ..models.model import make_model
from ..parallel import mesh
from ..utils.logging import (para_and_log, print_metrics, report_time_eval,
                             report_time_train, setuplogger)
from .checkpoint import (epoch_from_name, get_checkpoint, latest_checkpoint,
                         load_checkpoint, save_checkpoint)
from .evaluate import compute_item_embeddings, eval_mode, evaluate
from .special_eval import (encode_new_items, eval_cold, eval_new,
                           read_behaviors_special)
from .state import count_params, make_train_state, param_labels
from .step import dedup_pack, make_train_step


def check_supported(cfg: Config) -> None:
    """Raises NotImplementedError for a configuration the port's runner does
    not run, naming the ROADMAP item that brings it (or saying that none
    will)."""
    later = [
        (cfg.user_tower == "dssm" and cfg.use_modal
         and cfg.stage == "two_stage",
         "user_tower='dssm' with stage='two_stage' (no reference variant; "
         "the JAX runner's DSSM data builds no two-stage cache)"),
    ]
    bad = [what for cond, what in later if cond]
    if bad:
        raise NotImplementedError("not ported: " + "; ".join(bad))


class _DSSMEvalBatches:
    """DSSM eval (JAX runner ``_dssm_eval_batches``): every (user, target)
    pair scored against the catalog (reference bce_text/main-end2end(DSSM)/
    data_utils/metrics.py:93-120), in batches of ``EvalBatches``' 5-tuple
    with user ids in the id slot and a (B, 1) zero log mask; the histories
    are indexed by user id (1-based), so row uid - 1."""

    def __init__(self, pairs: np.ndarray, history: np.ndarray,
                 batch_size: int):
        self.pairs = pairs
        self.history = history
        self.batch_size = batch_size
        self.n = pairs.shape[0]
        self.total = ((self.n + batch_size - 1) // batch_size) * batch_size

    def __iter__(self):
        for i in range(0, self.total, self.batch_size):
            idx = np.minimum(np.arange(i, i + self.batch_size), self.n - 1)
            users = self.pairs[idx, 0].astype(np.int32)
            target = self.pairs[idx, 1].astype(np.int32)
            hist = self.history[np.minimum(users - 1,
                                           self.history.shape[0] - 1)]
            lm = np.zeros((len(idx), 1), np.float32)
            valid = np.arange(i, i + self.batch_size) < self.n
            yield users, lm, target, hist, valid


def _groups(batches, k: int):
    """The batches in lists of k (the last one shorter)."""
    group = []
    for b in batches:
        group.append(b)
        if len(group) == k:
            yield group
            group = []
    if group:
        yield group


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Trainer:
    """Drives one experiment. Data, encoder and tokenizer are injectable.

    encoder_bundle: (module, net_state_dict or None, frozen parameter
    names, feature width) for a modal item tower -- the module built on the
    trainer's device (``TextTower``, ``VisionTower``; for a two-stage tower
    built with ``project=False``), the state_dict of its pretrained ``net``
    (a ResNet's BatchNorm buffers included) to load over the drawn weights
    (``load_net_state``),
    the names ``param_labels`` freezes (``convert``'s ``*_frozen_names``
    of the text families, or ``convert.frozen_names`` of
    ``vision_frozen_paths``; end2end only): ``load_encoder``'s.
    tokenizer: the text items' tokenizer (``data/preprocess.py``
    ``read_items_tokenized``), for a text modal tower.
    """

    vision_pipe = None   # set for vision end2end (data/vision_loader.py)
    user_num = 0         # DSSM's users, set by its data

    def __init__(self, cfg: Config, log_file=None, log_screen=None, *,
                 device=None, encoder_bundle=None, tokenizer=None):
        check_supported(cfg)
        self.cfg = cfg
        self.device = on_device(device)
        self.n_shards = mesh.process_count()
        if log_file is None:
            time_run = time.strftime("-%Y%m%d-%H%M%S", time.localtime())
            log_file, log_screen = setuplogger(
                cfg.dir_label(), cfg.log_paras(self.n_shards), time_run,
                cfg.mode, cfg.behaviors)
            if not mesh.is_coordinator():
                # reference rank gating: non-rank-0 loggers log WARN+ only
                log_file.setLevel(logging.WARNING)
                log_screen.setLevel(logging.WARNING)
        self.log = log_file
        self.log_screen = log_screen or log_file
        self.encoder_bundle = encoder_bundle
        self.tokenizer = tokenizer
        self.model_dir = cfg.model_dir(self.n_shards)
        self.valid_results: Dict[int, dict] = {}   # epoch -> run_eval's
        self.last_eval: Optional[dict] = None
        self.special_results: Dict[str, dict] = {}   # run_special_eval's
        self.train_stats = {"seconds": 0.0, "samples": 0, "steps": 0}

    # ----------------------------------------------------------------- data
    def load_data(self):
        cfg = self.cfg
        base = os.path.join(cfg.root_data_dir, cfg.dataset)
        if cfg.user_tower == "dssm":
            self._load_dssm_data(base)
            return
        if cfg.use_modal and cfg.stage == "two_stage":
            self._load_two_stage(base)
            return
        if cfg.use_modal and cfg.modality == "vision":
            from ..data.imagestore import open_store
            from ..data.vision_loader import VisionBatchPipe
            keys_dic, n2i, i2n = read_image_manifest(
                os.path.join(base, cfg.news))
            bd = read_behaviors(os.path.join(base, cfg.behaviors), keys_dic,
                                n2i, i2n, cfg.max_seq_len, cfg.min_seq_len,
                                self.log)
            store = open_store(os.path.join(base, cfg.image_store))
            self.vision_pipe = VisionBatchPipe(store, bd.item_id_to_dic,
                                               cfg.image_resize)
            self.set_data(bd, None)
            return
        if cfg.use_modal:
            dic, n2i, i2n = read_items_tokenized(
                os.path.join(base, cfg.news), cfg, self._tokenizer())
            bd = read_behaviors(os.path.join(base, cfg.behaviors), dic, n2i,
                                i2n, cfg.max_seq_len, cfg.min_seq_len,
                                self.log)
            item_content = build_doc_matrix(bd.item_id_to_dic, cfg)
        else:
            dic, n2i, i2n = read_items_text(os.path.join(base, cfg.news))
            bd = read_behaviors(os.path.join(base, cfg.behaviors), dic, n2i,
                                i2n, cfg.max_seq_len, cfg.min_seq_len,
                                self.log)
            item_content = None
        self.set_data(bd, item_content)

    def _tokenizer(self):
        if self.tokenizer is None:
            raise ValueError(
                "a text modal tower tokenizes its items: pass "
                "Trainer(..., tokenizer=...) (the HF tokenizer's call "
                "signature)")
        return self.tokenizer

    def _load_dssm_data(self, base: str):
        """DSSM (JAX runner.py:275-314): the (user, item) pairs of
        ``read_behaviors_pairs``, ``DSSMTrainBatcher`` over the train pairs
        with each user's train-and-valid items rejected as negatives, and
        the valid and test pairs as the eval batches; the id, text end2end
        and vision (MKV store) item towers."""
        cfg = self.cfg
        vision = cfg.use_modal and cfg.modality == "vision"
        news = os.path.join(base, cfg.news)
        if vision:
            dic, n2i, _ = read_image_manifest(news)
        elif cfg.use_modal:
            dic, n2i, _ = read_items_tokenized(news, cfg, self._tokenizer())
        else:
            dic, n2i, _ = read_items_text(news)
        pd = read_behaviors_pairs(os.path.join(base, cfg.behaviors), dic, n2i,
                                  cfg.min_seq_len, cfg.max_seq_len, self.log)
        self.item_num = pd.item_num
        self.user_num = pd.user_num
        self.item_content = None
        if vision:
            from ..data.imagestore import open_store
            from ..data.vision_loader import VisionBatchPipe
            store = open_store(os.path.join(base, cfg.image_store))
            self.vision_pipe = VisionBatchPipe(store, pd.item_id_to_content,
                                               cfg.image_resize)
        elif cfg.use_modal:
            self.item_content = torch.as_tensor(build_doc_matrix(
                pd.item_id_to_content, cfg)).long().to(self.device)
        self.log_pop = None
        self.batcher = DSSMTrainBatcher(pd.train_pairs, pd.users_valid,
                                        pd.item_num, cfg.neg_num,
                                        cfg.batch_size * self.n_shards,
                                        seed=cfg.seed)
        H = cfg.max_seq_len + 2
        ebs = cfg.eval_batch_size * self.n_shards
        self.eval_valid = _DSSMEvalBatches(
            pd.valid_pairs, pad_histories(pd.users_history_for_valid, H),
            ebs)
        self.eval_test = _DSSMEvalBatches(
            pd.test_pairs, pad_histories(pd.users_history_for_test, H), ebs)

    def _encode_catalog(self, bundle, content_for, item_num: int
                        ) -> torch.Tensor:
        """The two-stage cache (JAX runner.py:129-177; reference
        bce_text/main-2stage(SASRec)/data_utils/metrics.py:60-71): the
        bundle's tower, its parameters drawn from ``cfg.seed`` and its
        pretrained ``net`` loaded over them, run frozen, in eval mode and
        without gradients on the trainer's device, over ids 0..item_num in
        chunks of ``cfg.item_emb_batch_size`` (the last chunk padded with
        the last id). content_for(ids) maps a chunk's ids (numpy) to its
        content (token rows, images). Returns the (item_num + 1, width)
        float32 cache on the device, row 0 (the padding item) zero, where
        width is what the tower returns, and sets
        ``cfg.word_embedding_dim`` to it. (The JAX runner sizes the cache by
        the bundle's feature width, which a Swin tower's embedding_dim-wide
        classifier output does not fill: ROADMAP C9.)"""
        module, net_state = bundle[0], bundle[1]
        init_parameters(module, torch.Generator(
            device=self.device).manual_seed(self.cfg.seed))
        if net_state is not None:
            load_net_state(module.net, net_state)
        chunk = self.cfg.item_emb_batch_size
        total = item_num + 1
        cache = None
        with torch.no_grad(), eval_mode(module):
            for start in range(0, total, chunk):
                ids = np.minimum(np.arange(start, start + chunk), item_num)
                out = module(torch.as_tensor(content_for(ids)
                                             ).to(self.device)).float()
                if cache is None:
                    cache = torch.empty((total, out.shape[1]),
                                        dtype=torch.float32,
                                        device=self.device)
                n = min(chunk, total - start)
                cache[start:start + n] = out[:n]
        cache[0] = 0.0
        self.cfg.word_embedding_dim = int(cache.shape[1])
        return cache

    def _load_two_stage(self, base: str):
        """The behaviours, then the catalog cache through the bundle's
        frozen tower, then the encoder dropped (JAX runner.py:179-203): text
        from the tokenized titles, vision from the image store
        (``VisionBatchPipe.images_for``)."""
        cfg = self.cfg
        if self.encoder_bundle is None:
            raise ValueError("a two-stage tower caches its encoder's "
                             "outputs: pass Trainer(..., encoder_bundle=...)")
        news = os.path.join(base, cfg.news)
        if cfg.modality == "text":
            dic, n2i, i2n = read_items_tokenized(news, cfg, self._tokenizer())
            bd = read_behaviors(os.path.join(base, cfg.behaviors), dic, n2i,
                                i2n, cfg.max_seq_len, cfg.min_seq_len,
                                self.log)
            doc = build_doc_matrix(bd.item_id_to_dic, cfg).astype(np.int64)
            content_for = doc.__getitem__
        else:
            from ..data.imagestore import open_store
            from ..data.vision_loader import VisionBatchPipe
            keys_dic, n2i, i2n = read_image_manifest(news)
            bd = read_behaviors(os.path.join(base, cfg.behaviors), keys_dic,
                                n2i, i2n, cfg.max_seq_len, cfg.min_seq_len,
                                self.log)
            store = open_store(os.path.join(base, cfg.image_store))
            content_for = VisionBatchPipe(store, bd.item_id_to_dic,
                                          cfg.image_resize).images_for
        cache = self._encode_catalog(self.encoder_bundle, content_for,
                                     bd.item_num)
        self.encoder_bundle = None   # frozen and cached: dropped
        self.set_data(bd, cache)

    def set_data(self, bd: BehaviorData, item_content):
        """item_content: None (id, vision end2end), the token matrix (text
        end2end) or a two-stage tower's float32 cache, kept on the
        device."""
        cfg = self.cfg
        self.bd = bd
        self.item_num = bd.item_num
        if item_content is None:
            self.item_content = None
        else:
            content = torch.as_tensor(item_content)
            self.item_content = (content.float() if content.is_floating_point()
                                 else content.long()).to(self.device)
        # an item seen only in valid/test has popularity 0: log -inf, as in
        # the JAX package; no train batch holds it
        with np.errstate(divide="ignore"):
            log_pop = np.log(bd.pop_prob_list).astype(np.float32)
        self.log_pop = torch.from_numpy(log_pop).to(self.device)
        seqs, lens = pad_user_sequences(bd.users_train, cfg.seq_len_total)
        global_bs = cfg.batch_size * self.n_shards
        if cfg.loss == "inbatch_ce":
            self.batcher = TrainBatcher(seqs, lens, cfg.max_seq_len,
                                        global_bs, seed=cfg.seed)
        else:
            self.batcher = BCETrainBatcher(seqs, lens, cfg.max_seq_len,
                                           global_bs, self.item_num,
                                           seed=cfg.seed)
        H = cfg.max_seq_len + 2
        self.eval_valid = self._make_eval(bd.users_valid,
                                          bd.users_history_for_valid, H)
        self.eval_test = self._make_eval(bd.users_test,
                                         bd.users_history_for_test, H)

    def _make_eval(self, users_eval, histories, hist_width):
        cfg = self.cfg
        seqs, lens = pad_user_sequences(users_eval, cfg.seq_len_total)
        return EvalBatches(seqs, lens, cfg.max_seq_len,
                           cfg.eval_batch_size * self.n_shards,
                           pad_histories(histories, hist_width),
                           num_shards=1)

    # ---------------------------------------------------------------- model
    def build_model(self):
        """The model drawn from a generator seeded with ``cfg.seed`` (the
        bundle's pretrained net loaded over it), its optimizer groups (the
        encoder's and the recsys group end2end, one group for IDRec and the
        two-stage heads, JAX runner.py:353-365), and a dropout generator
        seeded with ``cfg.seed + 1``."""
        cfg = self.cfg
        bundle = self.encoder_bundle
        encoder = bundle[0] if bundle else None
        end2end = cfg.use_modal and cfg.stage == "end2end"
        if end2end and encoder is None:
            raise ValueError("an end2end modal item tower needs "
                             "Trainer(..., encoder_bundle=...)")
        gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        self.model = make_model(cfg, self.item_num,
                                encoder if end2end else None,
                                user_num=self.user_num,
                                device=self.device, generator=gen)
        labels = None
        if end2end:
            if bundle[1] is not None:
                load_net_state(self.model.encoder.net, bundle[1])
            labels = param_labels(self.model, frozen=bundle[2])
        n = count_params(self.model, labels)
        self.n_total, self.n_trainable = n["total"], n["trainable"]
        self.state = make_train_state(self.model, cfg, labels,
                                      seed=cfg.seed + 1)
        self.train_step = make_train_step(cfg, item_content=self.item_content,
                                          log_pop=self.log_pop)

    # ---------------------------------------------------------------- train
    def make_batch(self, raw) -> Dict[str, Any]:
        """One step's batch on the device from the batcher's global arrays
        (JAX runner.py:424-449): this rank's rows; SASRec's ids and log
        mask, with BCE the negatives' ids, dedup packing (``dedup_items``,
        one pack over the positives and negatives) and the images of a
        vision tower (``uniq_content``, or ``content`` and with BCE
        ``neg_content``); DSSM's users, items and labels, and the items'
        images (no dedup, as in the JAX package)."""
        cfg = self.cfg
        if self.n_shards > 1:
            rows = mesh.host_rows(len(raw[0]))
            raw = [a[rows] for a in raw]
        t = lambda a, dt: torch.from_numpy(np.asarray(a, dt))
        images = (self.vision_pipe.images_for
                  if self.vision_pipe is not None else None)
        if cfg.user_tower == "dssm":
            users, items, labels = raw
            host = {"users": t(users, np.int64), "items": t(items, np.int64),
                    "labels": t(labels, np.float32)}
            if images is not None:
                host["content"] = torch.from_numpy(images(items))
            return {k: v.to(self.device) for k, v in host.items()}
        ids, lm = raw[0], raw[-1]
        slots = [ids]
        host = {"ids": t(ids, np.int64), "log_mask": t(lm, np.float32)}
        if cfg.loss == "bce":
            slots.append(raw[1])
            host["neg_ids"] = t(raw[1], np.int64)
        if cfg.dedup_items and cfg.use_modal:
            packed = dedup_pack(np.concatenate([a.ravel() for a in slots]),
                                cfg.dedup_cap)
            if packed is not None:
                host["uniq_ids"], host["inverse"] = (torch.from_numpy(a)
                                                     for a in packed)
                if images is not None:
                    host["uniq_content"] = torch.from_numpy(
                        images(packed[0]))
        if images is not None and "uniq_ids" not in host:
            host["content"] = torch.from_numpy(images(ids))
            if cfg.loss == "bce":
                host["neg_content"] = torch.from_numpy(images(raw[1]))
        return {k: v.to(self.device) for k, v in host.items()}

    def run_eval(self, users: str = "valid") -> tuple:
        """(HR@10, nDCG@10) of the ``users`` split ("valid" or "test") over
        the whole catalog; ``last_eval`` keeps the per-user values and the
        encode and scoring seconds."""
        cfg = self.cfg
        content_fn = (self.vision_pipe.images_for
                      if self.vision_pipe is not None else None)
        _sync(self.device)
        t0 = time.perf_counter()
        table = compute_item_embeddings(
            self.model, self.item_num, self.item_content, cfg.embedding_dim,
            cfg.item_emb_batch_size, content_fn=content_fn)
        _sync(self.device)
        t1 = time.perf_counter()
        ev = self.eval_valid if users == "valid" else self.eval_test
        hit, ndcg, hits, ndcgs = evaluate(self.model, table, ev,
                                          per_user=True)
        t2 = time.perf_counter()
        self.last_eval = {"split": users, "hit": hit, "ndcg": ndcg,
                          "hits": hits, "ndcgs": ndcgs,
                          "items": self.item_num + 1, "users": len(hits),
                          "encode_s": t1 - t0, "score_s": t2 - t1}
        print_metrics([hit, ndcg], self.log, cfg.mode)
        return hit, ndcg

    def _resume(self) -> int:
        """Loads ``cfg.load_ckpt_name`` ("latest" for the newest) from the
        model directory; returns its epoch."""
        cfg = self.cfg
        if cfg.load_ckpt_name == "latest":
            ckpt_path = latest_checkpoint(self.model_dir)
            if ckpt_path is None:
                raise FileNotFoundError(f"no epoch-N.pt in {self.model_dir}")
            cfg.load_ckpt_name = os.path.basename(ckpt_path)
        else:
            ckpt_path = get_checkpoint(self.model_dir, cfg.load_ckpt_name)
            if ckpt_path is None:
                raise FileNotFoundError(
                    f"{cfg.load_ckpt_name} is not in {self.model_dir}")
        load_checkpoint(ckpt_path, self.state)
        self.log.info(f"Model loaded from {ckpt_path}")
        return epoch_from_name(cfg.load_ckpt_name)

    def _steps(self, batches):
        """Runs the batches' steps back to back and returns their losses,
        read together (one wait for the card a group)."""
        losses = [self.train_step(self.state, b) for b in batches]
        return torch.stack(losses).tolist()

    def train(self):
        cfg = self.cfg
        from ..data.vision_loader import Prefetcher
        start_time = time.time()
        start_epoch = 0
        is_early_stop = True
        if "None" not in cfg.load_ckpt_name:
            start_epoch = self._resume()
            is_early_stop = False

        global_bs = cfg.batch_size * self.n_shards
        steps_for_log, _ = para_and_log(
            self.n_total, self.n_trainable, self.batcher.n, global_bs,
            self.log, cfg.logging_num, cfg.testing_num)

        k = max(1, cfg.steps_per_dispatch)
        max_eval_value, max_epoch, early_stop_count = 0.0, 0, 0
        early_stop_epoch = cfg.epoch
        next_set_start = time.time()
        need_break = False
        last_log_t = time.time()
        for ep in range(cfg.epoch):
            now_epoch = start_epoch + ep + 1
            self.log.info(f"epoch {now_epoch} start")
            loss_sum, batch_index = 0.0, 1
            _sync(self.device)
            t_epoch = time.perf_counter()
            for group in _groups(Prefetcher(self.batcher.epoch(now_epoch),
                                            self.make_batch), k):
                losses = self._steps(group)
                self.train_stats["steps"] += len(group)
                self.train_stats["samples"] += len(group) * global_bs
                for loss in losses:
                    loss_sum += loss
                    if np.isnan(loss):
                        self.log.info(
                            "NaN loss — stopping (run.py:249-251 parity)")
                        need_break = True
                        break
                    if batch_index % steps_for_log == 0:
                        now = time.time()
                        sps = (steps_for_log * global_bs
                               / max(now - last_log_t, 1e-9))
                        last_log_t = now
                        self.log.info(
                            "cnt: {}, Ed: {}, batch loss: {:.5f}, sum loss: "
                            "{:.5f}, samples/s: {:.0f}".format(
                                batch_index, batch_index * global_bs,
                                loss_sum / batch_index, loss_sum, sps))
                    batch_index += 1
                if need_break:
                    break
            _sync(self.device)
            self.train_stats["seconds"] += time.perf_counter() - t_epoch

            if not need_break:
                eval_start = time.time()
                self.log.info("Validating...")
                hit, _ = self.run_eval("valid")
                self.valid_results[now_epoch] = self.last_eval
                report_time_eval(eval_start, self.log)
                if hit > max_eval_value:
                    max_eval_value, max_epoch = hit, now_epoch
                    early_stop_count = 0
                    save_checkpoint(self.model_dir, now_epoch, self.state,
                                    {"best": max_eval_value},
                                    self.log if mesh.is_coordinator()
                                    else None)
                else:
                    early_stop_count += 1
                    if early_stop_count > cfg.early_stop_gap:
                        early_stop_epoch = now_epoch
                        if is_early_stop:
                            need_break = True
            next_set_start = report_time_train(batch_index - 1, now_epoch,
                                               loss_sum, next_set_start,
                                               start_time, self.log)
            self.log_screen.info("{} training: epoch {}/{}".format(
                cfg.label_screen, now_epoch, cfg.epoch))
            if need_break:
                break
        self.log.info(" max eval Hit10 {:0.5f}  in epoch {}".format(
            max_eval_value * 100, max_epoch))
        self.log.info(" early stop in epoch {}".format(early_stop_epoch))
        return max_eval_value, max_epoch

    def test(self):
        """Standalone checkpoint evaluation on the test split (reference
        run_test.py:26-187), then, with ``cfg.cold_behaviors``, the cold and
        new-item evaluation (``run_special_eval``; a new-item file alone is
        ignored, as in the JAX package). Returns the test split's (HR@10,
        nDCG@10). Without a checkpoint of that name, the model as built is
        evaluated, as in the JAX package."""
        cfg = self.cfg
        if cfg.cold_behaviors and cfg.user_tower == "dssm":
            raise NotImplementedError(
                "cold/new-item evaluation scores SASRec users (the JAX "
                "package's special_eval); DSSM has no such evaluation")
        if cfg.load_ckpt_name == "latest":
            ckpt_path = latest_checkpoint(self.model_dir)
        else:
            ckpt_path = get_checkpoint(self.model_dir, cfg.load_ckpt_name)
        if ckpt_path:
            load_checkpoint(ckpt_path, self.state)
            self.log.info(f"Model loaded from {ckpt_path}")
        else:
            self.log.warning(f"no checkpoint {cfg.load_ckpt_name} in "
                             f"{self.model_dir}: testing the model as built")
        result = self.run_eval("test")
        if cfg.cold_behaviors:
            self.run_special_eval()
        return result

    def _before_catalog(self, base: str) -> tuple:
        """(content by id, id by name) of the "before" catalog that new
        items are looked up in: ``cfg.new_items`` or the catalog file (JAX
        runner.py:608-621)."""
        cfg = self.cfg
        path = os.path.join(base, cfg.new_items or cfg.news)
        if cfg.use_modal and cfg.modality == "text" and cfg.stage == "end2end":
            dic, n2i, _ = read_items_tokenized(path, cfg, self._tokenizer())
        elif cfg.use_modal and cfg.modality == "vision":
            dic, n2i, _ = read_image_manifest(path)
        else:
            dic, n2i, _ = read_items_text(path)
        return dic, n2i

    def _new_item_content(self, base: str, new_content: dict) -> np.ndarray:
        """The new items' content, row 0 the padding item's: token rows
        (``build_doc_matrix``), or the images of ``cfg.new_image_store`` (or
        the catalog's store) through the trainer's transform, a zero image
        first (JAX runner.py:641-662)."""
        cfg = self.cfg
        if cfg.modality == "text":
            return build_doc_matrix(new_content, cfg)
        keys = [new_content[i] for i in sorted(new_content)]
        transform = self.vision_pipe.transform
        if cfg.new_image_store:
            from ..data.imagestore import open_store
            path = os.path.join(base, cfg.new_image_store)
            # the store's images are views of its mapping: transformed
            # (copied) before it closes
            with contextlib.closing(open_store(path)) as store:
                imgs = transform([store.get(k) for k in keys])
        else:
            imgs = transform([self.vision_pipe.store.get(k) for k in keys])
        return np.concatenate([np.zeros((1,) + imgs.shape[1:], imgs.dtype),
                               imgs])

    def run_special_eval(self) -> tuple:
        """Cold-start and new-item evaluation (JAX runner.py:598-667; the
        reference's special.py, imported by inbatch_sasrec_e2e_vision/
        run_test.py:12): the cold users over the catalog's table, then,
        with a modal tower and ``cfg.new_behaviors``, the new users, each
        new item encoded by the item tower (``encode_new_items``) and
        appended to the catalog for its users. Returns ((HR@10, nDCG@10) of
        the cold users, that of the new users or None); ``special_results``
        keeps each one's per-user values, users and users/s, and the new
        items' encode items/s."""
        cfg = self.cfg
        base = os.path.join(cfg.root_data_dir, cfg.dataset)
        dic, before_n2i = self._before_catalog(base)
        new_path = (os.path.join(base, cfg.new_behaviors)
                    if cfg.new_behaviors else None)
        sc, hc, sn, hn, new_content = read_behaviors_special(
            os.path.join(base, cfg.cold_behaviors), new_path,
            self.bd.item_name_to_id, dic, before_n2i, cfg.use_modal)
        content_fn = (self.vision_pipe.images_for
                      if self.vision_pipe is not None else None)
        table = compute_item_embeddings(
            self.model, self.item_num, self.item_content, cfg.embedding_dim,
            cfg.item_emb_batch_size, content_fn=content_fn)

        def timed(what, fn):
            _sync(self.device)
            t0 = time.perf_counter()
            hit, ndcg, hits, ndcgs = fn()
            seconds = time.perf_counter() - t0
            self.special_results[what] = {
                "hit": hit, "ndcg": ndcg, "hits": hits, "ndcgs": ndcgs,
                "users": len(hits), "seconds": seconds,
                "users_per_s": len(hits) / max(seconds, 1e-9)}
            print_metrics([hit, ndcg], self.log, what)
            return hit, ndcg

        self.special_results = {}
        cold = timed("cold", lambda: eval_cold(
            self.model, table, sc, hc, cfg.max_seq_len, cfg.eval_batch_size,
            per_user=True))
        if sn is None:
            return cold, None
        if cfg.stage == "two_stage":
            raise NotImplementedError(
                "new-item evaluation of a two-stage tower: its head reads "
                "the frozen encoder's cache, which holds no new item (the "
                "JAX runner fails there too, after the cold users)")
        content = self._new_item_content(base, new_content)
        _sync(self.device)
        t0 = time.perf_counter()
        new_embs = encode_new_items(self.model, content,
                                    cfg.item_emb_batch_size,
                                    images=cfg.modality == "vision")
        _sync(self.device)
        encode_s = time.perf_counter() - t0
        new = timed("new", lambda: eval_new(
            self.model, table, new_embs, sn, hn, cfg.max_seq_len,
            cfg.eval_batch_size, per_user=True))
        self.special_results["new"].update(
            items=len(new_content), encode_s=encode_s,
            items_per_s=len(new_content) / max(encode_s, 1e-9),
            embeddings=new_embs)
        return cold, new


def load_encoder(cfg: Config, device) -> tuple:
    """The encoder bundle the CLI builds for a modal item tower (JAX
    encoders_zoo.py:47-56). Text: ``build_text_tower``'s, the tower of the
    HF model directory ``cfg.pretrained_models_dir/cfg.bert_model_load``
    (OPT, DeBERTa, DistilBERT, BERT or RoBERTa from its ``config.json``;
    its converted weights, or None where the directory holds none; the
    names frozen by the reference's index, ``freeze_paras_before``); the
    items' tokenizer stays the caller's (``Trainer(..., tokenizer=...)``).
    Vision: ``build_vision_tower``'s, the tower of ``cfg.cv_model_load``
    (ResNet-18 ... 152 from a torchvision ``.pth``; Swin, BEiT, CLIP or
    ViT-MAE from an HF model directory under ``pretrained_models_dir``;
    else the named default geometry), the checkpoint's converted weights
    or None (drawn by ``build_model``, two-stage by ``_encode_catalog``),
    end2end the names frozen by the reference's index
    (``vision_frozen_paths``), and the JAX package's feature width. A
    two-stage tower has ``project=False`` and is frozen whole (its
    ``_encode_catalog`` reads no frozen names)."""
    if cfg.modality == "text":
        from ..models.text_tower import build_text_tower
        return build_text_tower(cfg, device=device)
    from ..models.vision_tower import build_vision_tower
    tower, state, frozen, width = build_vision_tower(cfg, device=device)
    return (tower, state, frozen if cfg.stage == "end2end" else set(),
            width)


def load_net_state(net: torch.nn.Module, state) -> None:
    """Loads a converted checkpoint over a drawn net, as the JAX runner
    merges the converted tree over the drawn one (train/runner.py:139-144,
    :336-345): a parameter the converter leaves out keeps its drawn value,
    and only those (``net.drawn_on_load``: a ResNet's fc); any other
    missing or unexpected key raises."""
    missing, unexpected = net.load_state_dict(state, strict=False)
    drawn = tuple(getattr(net, "drawn_on_load", ()))
    missing = [k for k in missing if not k.startswith(drawn)]
    if missing or unexpected:
        raise KeyError(f"the checkpoint does not fit the net: missing "
                       f"{missing}, unexpected {unexpected}")


def run(cfg: Config, device=None):
    """The CLI's experiment: train (returns (best valid HR@10, its epoch))
    or test (returns (HR@10, nDCG@10)). ``device`` None is the card."""
    if cfg.distributed:
        mesh.init_distributed(cfg.process_id, cfg.num_processes,
                              init_method=f"tcp://{cfg.coordinator_address}")
    trainer = Trainer(cfg, device=device)
    if cfg.use_modal:
        trainer.encoder_bundle = load_encoder(cfg, trainer.device)
    trainer.load_data()
    trainer.build_model()
    if "train" in cfg.mode:
        return trainer.train()
    return trainer.test()
