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

``build_vision_tower`` reads a pretrained encoder where
``pretrained_models_dir`` holds one, as the JAX package does: a
torchvision ``.pth`` for a ResNet, an HF model directory (``config.json``
and ``model.safetensors`` or ``pytorch_model.bin``) for Swin, BEiT, CLIP
and ViT-MAE, converted by ``convert.py``.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..convert import (convert_beit_state_dict, convert_clip_state_dict,
                       convert_resnet_state_dict, convert_swin_state_dict,
                       convert_vit_mae_state_dict, frozen_names,
                       load_torch_state_dict)
from .beit import BeitConfig, BeitModel, beit_frozen_paths
from .clip_vit import CLIPVisionConfig, CLIPVisionModel, clip_frozen_paths
from .layers import Dense, on_device, xavier_normal_
from .resnet import ARCHS, ResNet, resnet_frozen_paths
from .swin import SwinConfig, SwinModel, swin_frozen_paths
from .vit_mae import ViTMAEConfig, ViTMAEModel, vit_mae_frozen_paths

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


# the HF families by the name's key, in the JAX package's order: (config,
# net, converter, frozen paths, default geometry of a name)
_FAMILIES = (
    ("swin", SwinConfig, SwinModel, convert_swin_state_dict,
     swin_frozen_paths,
     lambda name: SwinConfig() if "tiny" in name else SwinConfig.swin_base()),
    ("beit", BeitConfig, BeitModel, convert_beit_state_dict,
     beit_frozen_paths, lambda name: BeitConfig()),
    ("clip", CLIPVisionConfig, CLIPVisionModel, convert_clip_state_dict,
     clip_frozen_paths, lambda name: CLIPVisionConfig()),
    ("mae", ViTMAEConfig, ViTMAEModel, convert_vit_mae_state_dict,
     vit_mae_frozen_paths, lambda name: ViTMAEConfig()))
_NETS = {f[1]: f[2] for f in _FAMILIES}
_CONVERTERS = {f[1]: f[3] for f in _FAMILIES}
_FROZEN = {f[1]: f[4] for f in _FAMILIES}


def _encoder(cfg) -> tuple:
    """(kind, net config or ResNet arch, feature width, checkpoint) of
    ``cfg.cv_model_load`` by the JAX package's dispatch
    (vision_tower.py:81-190). A ResNet's checkpoint is the torchvision
    ``.pth`` at ``{dir}/{name}.pth`` or ``{dir}.pth``, where ``dir`` is
    ``pretrained_models_dir/cv_model_load`` and ``name`` the name with
    ``-`` as ``_``; an HF family's is the model directory ``dir``, whose
    ``config.json`` gives the geometry. None where there is none: the named
    default geometry."""
    name = cfg.cv_model_load.replace("-", "_")
    path = os.path.join(cfg.pretrained_models_dir, cfg.cv_model_load)
    if name.startswith("resnet") and name in ARCHS:
        # the fc to embedding_dim sits inside the net
        pth = next((p for p in (os.path.join(path, f"{name}.pth"),
                                path + ".pth") if os.path.exists(p)), None)
        return "resnet", name, cfg.embedding_dim, pth
    for key, config, *_, default in _FAMILIES:
        if key not in name:
            continue
        if os.path.isdir(path):
            with open(os.path.join(path, "config.json")) as f:
                net_cfg = config.from_dict(json.load(f))
        else:
            net_cfg, path = default(name), None
        feat = (net_cfg.num_features if config is SwinConfig
                else net_cfg.hidden_size)
        return "mae" if key == "mae" else "swin", net_cfg, feat, path
    raise ValueError(f"unknown cv_model_load {cfg.cv_model_load!r}")


def _pretrained(kind: str, net_cfg, ckpt: Optional[str]):
    """The checkpoint's state_dict of the net, converted (CPU, float32), or
    None: no checkpoint, or a model directory without weights, whose net is
    drawn as in the JAX package (its ``except (FileNotFoundError,
    OSError)``)."""
    if ckpt is None:
        return None
    if kind == "resnet":
        sd = torch.load(ckpt, map_location="cpu", weights_only=True)
        return convert_resnet_state_dict(sd, net_cfg)
    try:
        sd = load_torch_state_dict(ckpt)
    except (FileNotFoundError, OSError):
        return None
    return _CONVERTERS[type(net_cfg)](sd, net_cfg)


def check_kernel_widths(net_cfg) -> None:
    """Raises, naming the width, where a geometry lies outside what the
    card's kernels take, before anything is built: a pre-LN MLP's (C, F)
    outside ``premlp_plan``'s widths and F chunks (``fused_mlp``,
    ``fused_mlp_res``), a Swin stage's (window, C, heads) without a
    ``win_attn_plan`` in either dtype. Swin-L's last stage, C 1536, is one.
    A ResNet runs no hand-written kernel."""
    from ..ops.cuda.attention import win_attn_plan
    from ..ops.cuda.mlp import PRE_F_CHUNK
    if isinstance(net_cfg, str):
        return
    what = type(net_cfg).__name__
    if isinstance(net_cfg, SwinConfig):
        side, C = net_cfg.image_size // net_cfg.patch_size, net_cfg.embed_dim
        stages = []
        for heads in net_cfg.num_heads:
            stages.append((C, int(C * net_cfg.mlp_ratio), heads,
                           min(net_cfg.window_size, side) ** 2))
            side, C = (side + 1) // 2, 2 * C
    else:
        stages = [(net_cfg.hidden_size, net_cfg.intermediate_size, None,
                   None)]
    for s, (C, F, heads, T) in enumerate(stages):
        where = f"{what} stage {s}" if heads else what
        if C not in PRE_F_CHUNK or F % PRE_F_CHUNK[C]:
            raise ValueError(
                f"{where}: the pre-LN MLP's width C={C} (F={F}) is not one "
                f"the card's kernels take (C in {sorted(PRE_F_CHUNK)}, F a "
                f"multiple of the width's chunk)")
        if heads and any(win_attn_plan(T, C, heads, dt) is None
                         for dt in (torch.bfloat16, torch.float32)):
            raise ValueError(
                f"{where}: no window attention kernel plan at C={C} with "
                f"{heads} heads of {C // heads} columns, {T}-token windows")


def build_vision_tower(cfg, device=None) -> tuple:
    """The encoder bundle (JAX vision_tower.py ``build_vision_tower``):
    (tower, the net's pretrained state_dict or None, the port names of the
    parameters the reference freezes, feature width) for
    ``cfg.cv_model_load`` (and ``cfg.embedding_dim``, ``cfg.compute_dtype``,
    ``cfg.stage``, ``cfg.freeze_paras_before``), the tower built on
    ``device`` (the GPU when None, ``on_device``) with its parameters still
    to be drawn (``make_model`` or ``init_parameters``) and the state loaded
    over them (``runner.load_net_state``). ResNet-18 ... 152 (``resnetNN``;
    its BatchNorm computes in the compute dtype, JAX vision_tower.py:93-95)
    from a torchvision ``.pth``; Swin (a name holding ``swin``), BEiT
    (``beit``), CLIP (``clip``) and ViT-MAE (``mae``) from an HF model
    directory, its ``config.json`` and its weights; without a checkpoint
    the named default geometry: Swin-T (``swin*tiny``) or Swin-B,
    BEiT-B/16, CLIP-B/32, ViT-MAE-B/16 (``_encoder``). On the card a
    geometry its kernels do not take is refused (``check_kernel_widths``).
    The feature width is the JAX package's: the net's pooled width, a
    ResNet's embedding_dim."""
    kind, net_cfg, feat, ckpt = _encoder(cfg)
    device = on_device(device)
    if device.type == "cuda":
        check_kernel_widths(net_cfg)
    state = _pretrained(kind, net_cfg, ckpt)
    bf16 = getattr(cfg, "compute_dtype", "float32") == "bfloat16"
    net = (ResNet(net_cfg, cfg.embedding_dim, device=device)
           if kind == "resnet" else _NETS[type(net_cfg)](net_cfg,
                                                         device=device))
    tower = VisionTower(net, kind, cfg.embedding_dim, feat,
                        project=getattr(cfg, "stage", "end2end") == "end2end",
                        compute_dtype=torch.bfloat16 if bf16 else None,
                        device=device)
    return (tower, state,
            frozen_names(_frozen_paths(net_cfg, cfg.freeze_paras_before)),
            feat)


def _frozen_paths(net_cfg, n: int) -> set:
    if isinstance(net_cfg, str):
        return resnet_frozen_paths(net_cfg, n, NET_PREFIX)
    return _FROZEN[type(net_cfg)](net_cfg, n, NET_PREFIX)


def vision_frozen_paths(cfg) -> set:
    """Flax paths, under ``encoder.net``, of the parameters the reference
    freezes for ``cfg.cv_model_load``: the encoder's first
    ``cfg.freeze_paras_before`` in its torchvision or HF
    ``named_parameters()`` order (a ResNet's fc excepted), over the
    geometry ``build_vision_tower`` builds (a model directory's
    ``config.json``)."""
    return _frozen_paths(_encoder(cfg)[1], cfg.freeze_paras_before)
