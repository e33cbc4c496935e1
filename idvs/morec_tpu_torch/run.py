"""CLI entry point: python -m idvs.morec_tpu_torch.run --flags...

The JAX package's flag surface (idvs/morec_tpu/run.py; ``config.py``
``parse_args``: the union of the reference's 12 parameters.py files plus
the variant axes --loss/--user_tower/--stage/--modality). It runs on the
card and raises when no GPU is visible; on the CPU, drive
``train.runner.Trainer(cfg, device="cpu")`` or ``run(cfg, device="cpu")``.
IDRec and every vision tower (ResNet-18 ... 152, Swin, BEiT, CLIP,
ViT-MAE; end2end, ID+modality fusion and two-stage) run from the command
line, from a torchvision ``.pth`` or an HF model directory under
``--pretrained_models_dir`` when there is one, else drawn at the named
geometry; a text tower needs a tokenizer (``train/runner.py``
``load_encoder``). ``launcher.py`` runs a ``variants/`` file's grid
through ``main``.
"""

from .config import parse_args
from .train.runner import run


def main(argv=None, device=None):
    return run(parse_args(argv), device=device)


if __name__ == "__main__":
    main()
