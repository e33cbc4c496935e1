"""Vision item tower (JAX twin: models/vision_tower.py): NHWC images -> item
embeddings.

For the Swin family the tower is GELU(classifier(pooled)), the classifier a
Linear from the network's features to the embedding dim (the reference's
Vit_Encoder). uint8 images are normalised on the device, ToTensor +
Normalize((.5, .5, .5), (.5, .5, .5)). With ``project=False`` (the
two-stage towers' frozen encoder, reference bce_vision/main-2stage(SASRec)/
run.py:64-69) it returns the classifier's output before the GELU,
embedding_dim wide. Only ``kind="swin"`` is ported; ResNet, MAE, BEiT and
CLIP come with a later slice.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .layers import Dense, on_device, xavier_normal_
from .swin import SwinConfig, SwinModel

CV_MODEL_TABLE = {
    # name -> (kind, feature width); the reference's 'swin_tiny', 'swin_base'
    "swin_tiny": ("swin", 768), "swin-tiny": ("swin", 768),
    "swin_small": ("swin", 768), "swin_base": ("swin", 1024),
    "swin-base": ("swin", 1024),
}
_LATER = ("resnet", "mae", "beit", "clip")


class VisionTower(nn.Module):
    def __init__(self, net: nn.Module, kind: str, embedding_dim: int,
                 feature_dim: int, project: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if kind != "swin":
            raise NotImplementedError(
                f"VisionTower kind={kind!r}: only 'swin' is ported; the "
                f"other encoders come with a later slice")
        self.net, self.kind = net, kind
        self.project = project
        self.compute_dtype = compute_dtype
        self.classifier = Dense(feature_dim, embedding_dim,
                                init=xavier_normal_, device=device)

    def forward(self, images: torch.Tensor, generator=None,
                pad_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """(N, H, W, 3) uint8 or normalised float images -> (N,
        embedding_dim), before the GELU with ``project=False``; pad_mask
        (N,) marks the padding item's slots."""
        if not images.is_floating_point():
            images = (images.float() / 255.0 - 0.5) / 0.5
        if pad_mask is not None:
            # the padding item's image is zero in NORMALISED space, which
            # uint8 content cannot say (uint8 zeros normalise to -1)
            images = torch.where(pad_mask[:, None, None, None],
                                 torch.zeros((), dtype=images.dtype,
                                             device=images.device), images)
        if self.compute_dtype is not None:
            images = images.to(self.compute_dtype)
        feats = self.classifier(self.net(images, generator))
        if not self.project:
            return feats
        return F.gelu(feats, approximate="none")


def build_vision_tower(cfg, device=None) -> VisionTower:
    """The tower for ``cfg.cv_model_load`` (and ``cfg.embedding_dim``,
    ``cfg.compute_dtype``, ``cfg.stage``) built from the default Swin-T or
    Swin-B geometry on ``device`` (the GPU when None, ``on_device``), its
    parameters still to be drawn (``make_model`` or
    ``init_parameters``) or loaded. Reading a pretrained checkpoint
    directory waits until such files are at hand."""
    name = cfg.cv_model_load.replace("-", "_")
    if any(k in name for k in _LATER) or "vit" in name:
        raise NotImplementedError(
            f"cv_model_load={cfg.cv_model_load!r}: only the Swin towers are "
            f"ported; ResNet, MAE, BEiT and CLIP come with a later slice")
    if name not in CV_MODEL_TABLE:
        raise ValueError(f"unknown cv_model_load {cfg.cv_model_load!r}")
    # as the JAX package: Swin-T for the 'tiny' names, else Swin-B
    scfg = SwinConfig() if "tiny" in name else SwinConfig.swin_base()
    device = on_device(device)
    bf16 = getattr(cfg, "compute_dtype", "float32") == "bfloat16"
    return VisionTower(SwinModel(scfg, device=device), "swin",
                       cfg.embedding_dim, scfg.num_features,
                       project=(getattr(cfg, "stage", "end2end")
                                == "end2end"),
                       compute_dtype=torch.bfloat16 if bf16 else None,
                       device=device)
