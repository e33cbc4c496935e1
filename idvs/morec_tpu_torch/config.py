"""Experiment configuration (JAX twin: idvs/morec_tpu/config.py, copied so
that the port imports nothing of the JAX package).

One dataclass covers the union of all 12 reference variants' argparse flag
sets (reference: <variant>/parameters.py, e.g.
inbatch_sasrec_e2e_text/parameters.py:4-50,
bce_text/main-end2end(DSSM)/parameters.py, bce_vision/*/parameters.py),
plus the JAX package's own knobs, so that one command line parses alike in
both packages. The reference encodes the variant choice in the directory
tree; here it is four config axes: loss / user_tower / item_tower / stage
(+ modality).

The port reads the fields its runner uses (``train/runner.py``); the JAX
package's TPU knobs (``data_axis``, ``dropout_prng``,
``encoder_chunk_unroll``, ``zero1_table``, ``profile_dir``, the
``jax.distributed`` flags) parse and are ignored.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import List, Optional, Sequence


def str2bool(v) -> bool:
    # CLI-compatible with reference data_utils/utils.py:10-18.
    if isinstance(v, bool):
        return v
    if v.lower() in ("yes", "true", "t", "y", "1"):
        return True
    if v.lower() in ("no", "false", "f", "n", "0"):
        return False
    raise argparse.ArgumentTypeError("Boolean value expected.")


@dataclasses.dataclass
class Config:
    # ---- variant axes (replaces the reference's 12 variant directories) ----
    mode: str = "train"            # 'train' | 'test'
    loss: str = "inbatch_ce"       # 'inbatch_ce' | 'bce'
    user_tower: str = "sasrec"     # 'sasrec' | 'dssm'
    item_tower: str = "id"         # 'id' | 'modal' | 'modal_id_add' | 'modal_id_cat'
    stage: str = "end2end"         # 'end2end' | 'two_stage'
    modality: str = "text"         # 'text' | 'vision'

    # ---- data ----
    root_data_dir: str = "../"
    dataset: str = "MIND-small"
    behaviors: str = "behaviors_l5_tr_v.tsv"
    news: str = "news_l5_tr_v.tsv"          # text item TSV (vision: image manifest TSV)
    image_store: str = "hm_images.mkv"      # vision record store (reference: LMDB dir)
    max_seq_len: int = 20
    min_seq_len: int = 5
    cold_behaviors: str = ""   # cold-start eval TSV ('' = off), test mode
    new_behaviors: str = ""    # new-item eval TSV ('' = off), test mode
    new_items: str = ""        # UNSEEN items' own manifest TSV ('' = the
                               # main catalog file carries them; reference
                               # vision reads new items from a separate file,
                               # inbatch_sasrec_e2e_vision/data_utils/
                               # special.py:73-80 + parameters.py:18)
    new_image_store: str = ""  # separate store for unseen items' images
                               # (reference keeps new-item images in their own
                               # LMDB, inbatch_sasrec_e2e_vision/special.py)
    num_words_title: int = 30
    num_words_abstract: int = 50
    num_words_body: int = 50
    news_attributes: Sequence[str] = ("title",)
    image_resize: int = 224

    # ---- train ----
    batch_size: int = 64            # per-chip batch (reference: per-GPU)
    epoch: int = 1
    lr: float = 1e-4
    fine_tune_lr: float = 5e-5
    l2_weight: float = 0.0
    fine_tune_l2_weight: float = 0.0
    drop_rate: float = 0.1
    neg_num: int = 1                # DSSM negatives per positive
    accumulation_step: int = 1      # gradient accumulation (train/state.py accumulate)
    seed: int = 12345

    # ---- model ----
    bert_model_load: str = "bert-base-uncased"
    cv_model_load: str = "swin-tiny"
    freeze_paras_before: int = 0
    word_embedding_dim: int = 768   # modality-encoder hidden size (auto-set per encoder)
    embedding_dim: int = 256
    num_attention_heads: int = 2
    transformer_block: int = 2
    dnn_layers: int = 0             # DSSM MLP depth / two-stage MLP depth
                                    # (id_plus_mo-2stage: POST-fusion MLP depth,
                                    # bce_text/id_plus_mo-2stage/model/model.py:38-40)
    mo_dnn_layers: int = 0          # id_plus_mo-2stage: depth of the FC stack
                                    # applied to the cached content BEFORE
                                    # fusion (reference FC_Layers 'turn_dim',
                                    # bce_text/id_plus_mo-2stage/model/model.py:25-27,
                                    # parameters.py:25)
    cat_layers: int = 1             # CAT fusion MLP depth; the reference
                                    # item_tower value 'modal_cat_3' selects 3
                                    # (bce_text/id_plus_mo-end2end/model/
                                    # model.py:28-34) and maps here to
                                    # item_tower=modal_id_cat + cat_layers=3
    pretrained_models_dir: str = "pretrained_models"
    text_pooling: str = ""          # '' = reference default (cls for BERT,
                                    # mean for OPT); 'cls'|'mean' to override

    # ---- eval / logging / ckpt ----
    load_ckpt_name: str = "None"
    label_screen: str = "None"
    logging_num: int = 8
    testing_num: int = 1
    num_workers: int = 0
    eval_batch_size: int = 512
    early_stop_gap: int = -1   # -1 = auto: 10 text / 6 vision (reference
                               # run.py early-stop counts; vision uses 6,
                               # inbatch_sasrec_e2e_vision/run.py:185-188)
    item_emb_batch_size: int = 512

    # ---- the JAX package's own knobs (no reference equivalent) ----
    data_axis: int = 0                  # JAX mesh axis size; ignored here
    # Multi-process data parallelism: the JAX package calls
    # jax.distributed.initialize() with these; the port's runner reads
    # ``distributed`` only (parallel/mesh.py ``init_distributed`` from the
    # torchrun environment).
    distributed: bool = False
    coordinator_address: str = ""
    num_processes: int = 0
    process_id: int = -1
    gather_negatives: bool = False      # all-gather in-batch negatives across DP
    param_dtype: str = "float32"
    compute_dtype: str = "bfloat16"
    # The in-batch CE through its kernels (ops/cuda/inbatch_ce.py) in place
    # of the composition of ops/losses.py; the same loss.
    use_pallas: bool = False
    # Encode only the batch's UNIQUE items through the modality encoder and
    # scatter the results back (host-side dedup, capacity dedup_cap; batches
    # with more uniques fall back to full encoding). Exact for eval/frozen
    # paths; under encoder dropout, duplicate occurrences share one dropout
    # draw (the reference draws per occurrence), so default off for strict
    # parity.
    dedup_items: bool = False
    dedup_cap: int = 0   # 0 = auto (3/4 of the batch's item slots)
    remat_encoder: bool = False         # checkpoint the item encoder
    # Encode item content in chunks of this many items, each checkpointed:
    # caps the encoder's activation memory at one chunk's. 0 = off.
    encoder_chunk: int = 0
    encoder_chunk_unroll: int = 8       # JAX scan unrolling; ignored here
    dropout_prng: str = "rbg"           # JAX PRNG choice; ignored here
    # Train steps a dispatch in the JAX package (one compiled scan); the
    # port runs them as that many single steps, the same updates.
    steps_per_dispatch: int = 1
    zero1_table: bool = True            # JAX ZeRO-1 table moments; ignored
    profile_dir: str = ""               # JAX profiler trace dir; ignored

    def __post_init__(self):
        if isinstance(self.news_attributes, str):
            self.news_attributes = tuple(self.news_attributes.split(","))
        else:
            self.news_attributes = tuple(self.news_attributes)
        # Reference encodes modality use in the item_tower string
        # (run.py:325-332: "'modal' in args.item_tower").
        assert self.loss in ("inbatch_ce", "bce")
        assert self.user_tower in ("sasrec", "dssm")
        # the reference's DSSM variants are BCE-only (bce_*/main-end2end(DSSM))
        assert not (self.user_tower == "dssm" and self.loss != "bce"), \
            "DSSM supports loss='bce' only"
        assert self.item_tower in ("id", "modal", "modal_id_add", "modal_id_cat")
        assert self.stage in ("end2end", "two_stage")
        assert self.modality in ("text", "vision")
        if self.early_stop_gap < 0:
            self.early_stop_gap = 6 if self.modality == "vision" else 10

    # -- derived properties ------------------------------------------------
    @property
    def use_modal(self) -> bool:
        return "modal" in self.item_tower

    @property
    def use_fusion(self) -> bool:
        return self.item_tower in ("modal_id_add", "modal_id_cat")

    @property
    def seq_len_total(self) -> int:
        # reference pads user sequences to max_seq_len + 1 items
        return self.max_seq_len + 1

    def dir_label(self) -> str:
        # reference run.py:325-332
        if self.use_modal:
            model_load = (self.bert_model_load if self.modality == "text"
                          else self.cv_model_load)
            return f"{self.item_tower}_{model_load}_freeze_{self.freeze_paras_before}"
        return str(self.item_tower)

    def log_paras(self, world_size: int = 1) -> str:
        # reference run.py:334-337
        model_load = ("id" if not self.use_modal else
                      (self.bert_model_load if self.modality == "text"
                       else self.cv_model_load))
        bs = self.batch_size * world_size
        return (f"{model_load}_ed_{self.embedding_dim}"
                f"_bs_{bs}_lr_{self.lr}_Flr_{self.fine_tune_lr}"
                f"_L2_{self.l2_weight}_FL2_{self.fine_tune_l2_weight}")

    def model_dir(self, world_size: int = 1) -> str:
        import os
        return os.path.join("./checkpoint_" + self.dir_label(),
                            "cpt_" + self.log_paras(world_size))


# Reference flag name -> Config field. A verbatim reference command line
# (any of the 12 <variant>/parameters.py flag sets) parses unchanged:
# --images/--lmdb_data (inbatch_sasrec_e2e_vision/parameters.py:13-14),
# --CV_resize/--CV_model_load (ibid:20-21), --dnn_layer singular
# (bce_text/main-2stage(SASRec)/parameters.py:21), and the special-eval
# sextet (--cold_file/--new_file text, parameters.py:15-16;
# --cold_seqs/--new_seqs/--new_items/--new_lmdb_data vision,
# inbatch_sasrec_e2e_vision/parameters.py:16-19).
REF_FLAG_ALIASES = {
    "images": "news",
    "lmdb_data": "image_store",
    "CV_resize": "image_resize",
    "CV_model_load": "cv_model_load",
    "dnn_layer": "dnn_layers",
    "cold_file": "cold_behaviors",
    "cold_seqs": "cold_behaviors",
    "new_file": "new_behaviors",
    "new_seqs": "new_behaviors",
    "new_lmdb_data": "new_image_store",
}

# Reference flag VALUES with a different spelling here:
# - item_tower 'modal_add'/'modal_cat' (id_plus_mo variants' launchers,
#   e.g. bce_text/id_plus_mo-2stage/train_bert_add.py:16) name the same
#   towers our config calls modal_id_add/modal_id_cat
# - the special-eval files use 'None' = off (parameters.py defaults);
#   our config uses '' = off
_ITEM_TOWER_VALUES = {"modal_add": "modal_id_add", "modal_cat": "modal_id_cat",
                      "modal_cat_3": "modal_id_cat"}
_NONE_IS_OFF = ("cold_behaviors", "new_behaviors", "new_items",
                "new_image_store")


def _add_flags(parser: argparse.ArgumentParser) -> None:
    """The union of all 12 reference parameters.py flag sets, same names."""
    fields = {f.name: f for f in dataclasses.fields(Config)}
    for name, f in fields.items():
        if name == "news_attributes":
            parser.add_argument("--news_attributes", type=str, default="title")
            continue
        t = f.type if isinstance(f.type, type) else type(f.default)
        if t is bool:
            parser.add_argument(f"--{name}", type=str2bool, default=f.default)
        elif t in (int, float, str):
            parser.add_argument(f"--{name}", type=t, default=f.default)
    for alias, dest in REF_FLAG_ALIASES.items():
        f = fields[dest]
        field_type = f.type if isinstance(f.type, type) else type(f.default)
        if field_type is bool:   # bool('False') is True — same str2bool as
            field_type = str2bool   # the canonical loop above
        parser.add_argument(f"--{alias}", dest=dest, type=field_type,
                            default=argparse.SUPPRESS)
    # accepted for reference-CLI compatibility; ignored
    parser.add_argument("--local_rank", type=int, default=-1)


def parse_args(argv: Optional[List[str]] = None,
               base: Optional[dict] = None) -> Config:
    """argv: reference-compatible flag list. base: variant-axis defaults
    (loss/user_tower/item_tower/stage/modality) — the reference encodes
    these in the directory path, so a verbatim reference command line is
    parsed as parse_args(ref_argv, base=axes_for(variant_dir))."""
    parser = argparse.ArgumentParser()
    _add_flags(parser)
    if base:
        parser.set_defaults(**base)
    ns = parser.parse_args(argv)
    d = vars(ns)
    d.pop("local_rank", None)
    if d["item_tower"] == "modal_cat_3":
        # 'cat_3' selects a 3-layer CAT MLP in the end2end fusion variants
        # (bce_text/id_plus_mo-end2end/model/model.py:28-34)
        d["cat_layers"] = 3
    d["item_tower"] = _ITEM_TOWER_VALUES.get(d["item_tower"], d["item_tower"])
    for k in _NONE_IS_OFF:
        if d.get(k) == "None":
            d[k] = ""
    return Config(**d)
