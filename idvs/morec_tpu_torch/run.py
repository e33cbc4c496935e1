"""CLI entry point: python -m idvs.morec_tpu_torch.run --flags...

The JAX package's flag surface (idvs/morec_tpu/run.py; ``config.py``
``parse_args``: the union of the reference's 12 parameters.py files plus
the variant axes --loss/--user_tower/--stage/--modality). It runs on the
card and raises when no GPU is visible; on the CPU, drive
``train.runner.Trainer(cfg, device="cpu")`` or ``run(cfg, device="cpu")``.
IDRec and every vision tower (ResNet-18 ... 152, Swin-T / B, BEiT-B/16,
CLIP-B/32, ViT-MAE-B/16; end2end, ID+modality fusion and two-stage) run
from the command line; a text tower needs a tokenizer and BERT weights
(``train/runner.py`` ``load_encoder``).
"""

from .config import parse_args
from .train.runner import run


def main(argv=None):
    return run(parse_args(argv))


if __name__ == "__main__":
    main()
