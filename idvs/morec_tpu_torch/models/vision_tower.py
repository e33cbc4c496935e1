"""Vision item tower (JAX twin: models/vision_tower.py): NHWC images -> item
embeddings, over the reference's encoder wrappers
(inbatch_sasrec_e2e_vision/model/encoders.py:7-41, run.py:27-56):

- ``kind="resnet"``: GELU(resnet(x)), the torchvision fc replaced by a
  Dense to embedding_dim inside the net (``ResNet.fc``);
- ``kind="swin"`` (Swin, BEiT, CLIP: Vit_Encoder): GELU(classifier(pooled)),
  the ``classifier`` a Dense from the net's features to embedding_dim;
- ``kind="mae"``: GELU(cv_proj(last_hidden[:, 0])).

uint8 images are normalised on the device, ToTensor + Normalize((.5, .5,
.5), (.5, .5, .5)). With ``project=False`` (the two-stage towers' frozen
encoder, reference bce_vision/main-2stage(SASRec)/run.py:64-69) it returns
the features before the GELU, embedding_dim wide. A ResNet's BatchNorm
runs on the batch's statistics in training mode and on its running
averages in eval mode (``models/resnet.py``); ViT-MAE masks its patches in
both (``models/vit_mae.py``).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from .beit import BeitConfig, BeitModel, beit_frozen_paths
from .clip_vit import CLIPVisionConfig, CLIPVisionModel, clip_frozen_paths
from .layers import Dense, on_device, xavier_normal_
from .resnet import ARCHS, ResNet, resnet_frozen_paths
from .swin import SwinConfig, SwinModel, swin_frozen_paths
from .vit_mae import ViTMAEConfig, ViTMAEModel, vit_mae_frozen_paths

CV_MODEL_TABLE = {
    # name -> (kind, feature width); the reference's 'resnet50',
    # 'swin_tiny', 'swin_base', 'mae'; any name holding 'beit' or 'clip' is
    # BEiT-B/16 or CLIP-B/32 ("swin" kind, 768 wide)
    "resnet18": ("resnet", 512), "resnet34": ("resnet", 512),
    "resnet50": ("resnet", 2048), "resnet101": ("resnet", 2048),
    "resnet152": ("resnet", 2048),
    "swin_tiny": ("swin", 768), "swin-tiny": ("swin", 768),
    "swin_small": ("swin", 768), "swin_base": ("swin", 1024),
    "swin-base": ("swin", 1024),
    "vit_mae": ("mae", 768), "mae": ("mae", 768),
}
KINDS = ("resnet", "swin", "mae")
NET_PREFIX = ("encoder", "net")


class VisionTower(nn.Module):
    def __init__(self, net: nn.Module, kind: str, embedding_dim: int,
                 feature_dim: int, project: bool = True,
                 compute_dtype: Optional[torch.dtype] = None, device=None):
        super().__init__()
        if kind not in KINDS:
            raise ValueError(f"VisionTower kind must be one of {KINDS}, got "
                             f"{kind!r}")
        self.net, self.kind = net, kind
        self.project = project
        self.compute_dtype = compute_dtype
        if kind == "swin":
            self.classifier = Dense(feature_dim, embedding_dim,
                                    init=xavier_normal_, device=device)
        elif kind == "mae":
            self.cv_proj = Dense(feature_dim, embedding_dim,
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
        if self.kind == "resnet":
            feats = self.net(images)
        elif self.kind == "swin":
            feats = self.classifier(self.net(images, generator))
        else:
            feats = self.cv_proj(self.net(images, generator)[:, 0])
        if not self.project:
            return feats
        return F.gelu(feats, approximate="none")


def _encoder(cfg) -> tuple:
    """(kind, net config or ResNet arch, feature width) of
    ``cfg.cv_model_load``, by the JAX package's name matching."""
    name = cfg.cv_model_load.replace("-", "_")
    D = cfg.embedding_dim
    if name.startswith("resnet") and name in ARCHS:
        # the fc to embedding_dim sits inside the net
        return "resnet", name, D
    if "swin" in name and name in CV_MODEL_TABLE:
        sc = SwinConfig() if "tiny" in name else SwinConfig.swin_base()
        return "swin", sc, sc.num_features
    if "beit" in name:
        return "swin", BeitConfig(), BeitConfig.hidden_size
    if "clip" in name:
        return "swin", CLIPVisionConfig(), CLIPVisionConfig.hidden_size
    if "mae" in name:
        return "mae", ViTMAEConfig(), ViTMAEConfig.hidden_size
    raise ValueError(f"unknown cv_model_load {cfg.cv_model_load!r}")


_NETS = {SwinConfig: SwinModel, BeitConfig: BeitModel,
         CLIPVisionConfig: CLIPVisionModel, ViTMAEConfig: ViTMAEModel}
_FROZEN = {SwinConfig: swin_frozen_paths, BeitConfig: beit_frozen_paths,
           CLIPVisionConfig: clip_frozen_paths,
           ViTMAEConfig: vit_mae_frozen_paths}


def build_vision_tower(cfg, device=None) -> VisionTower:
    """The tower for ``cfg.cv_model_load`` (and ``cfg.embedding_dim``,
    ``cfg.compute_dtype``, ``cfg.stage``) built from the named encoder's
    default geometry on ``device`` (the GPU when None, ``on_device``), its
    parameters still to be drawn (``make_model`` or ``init_parameters``)
    or loaded: ResNet-18 ... 152 (``resnetNN``; its BatchNorm computes in
    the compute dtype, JAX vision_tower.py:93-95), Swin-T (``swin*tiny``)
    or Swin-B (``swin_small``, ``swin_base``), BEiT-B/16 (a name holding
    ``beit``), CLIP-B/32 (``clip``), ViT-MAE-B/16 (``mae``), as the JAX
    package picks them. Reading a pretrained checkpoint waits until such
    files are at hand."""
    kind, net_cfg, feat = _encoder(cfg)
    device = on_device(device)
    bf16 = getattr(cfg, "compute_dtype", "float32") == "bfloat16"
    net = (ResNet(net_cfg, cfg.embedding_dim, device=device)
           if kind == "resnet" else _NETS[type(net_cfg)](net_cfg,
                                                         device=device))
    return VisionTower(net, kind, cfg.embedding_dim, feat,
                       project=getattr(cfg, "stage", "end2end") == "end2end",
                       compute_dtype=torch.bfloat16 if bf16 else None,
                       device=device)


def vision_frozen_paths(cfg) -> set:
    """Flax paths, under ``encoder.net``, of the parameters the reference
    freezes for ``cfg.cv_model_load``: the encoder's first
    ``cfg.freeze_paras_before`` in its torchvision or HF
    ``named_parameters()`` order (a ResNet's fc excepted)."""
    kind, net_cfg, _ = _encoder(cfg)
    n = cfg.freeze_paras_before
    if kind == "resnet":
        return resnet_frozen_paths(net_cfg, n, NET_PREFIX)
    return _FROZEN[type(net_cfg)](net_cfg, n, NET_PREFIX)
