"""Catalog encode (JAX twin: train/evaluate.py compute_item_embeddings)."""

from __future__ import annotations

import contextlib
from typing import Optional

import torch


@contextlib.contextmanager
def eval_mode(model):
    """Runs the block with ``model`` in eval mode (no dropout, no DropPath:
    the JAX package passes ``deterministic=True`` to every encode and
    request), then restores the caller's mode."""
    training = model.training
    model.eval()
    try:
        yield
    finally:
        model.train(training)


@torch.no_grad()
def compute_item_embeddings(model, item_num: int,
                            item_content: Optional[torch.Tensor],
                            embedding_dim: int,
                            batch_size: int = 512,
                            content_fn=None) -> torch.Tensor:
    """Runs the item tower over ids 0..item_num -> (item_num + 1, D) float32
    table on the model's device, in eval mode (``eval_mode``).

    The catalog goes through in fixed chunks of ``batch_size`` ids (the
    reference's item_emb_batch_size); the last chunk is padded with the last
    id so every chunk has the same shape. ``item_content`` holds the
    (item_num + 1, W) token rows on the device (None for the ID tower).
    ``content_fn``, when given, takes its place: it maps a chunk's ids (a
    numpy array) to the chunk's content (images from a store), as a numpy
    array or a tensor, which is moved to the model's device.
    """
    device = next(model.parameters()).device
    total = item_num + 1
    table = torch.empty((total, embedding_dim), dtype=torch.float32,
                        device=device)
    with eval_mode(model):
        for start in range(0, total, batch_size):
            ids = torch.arange(start, start + batch_size, device=device)
            ids = ids.clamp_max(item_num)
            if content_fn is not None:
                content = torch.as_tensor(content_fn(ids.cpu().numpy())
                                          ).to(device)
            else:
                content = None if item_content is None else item_content[ids]
            chunk = model.item_embs(ids, content)
            n = min(batch_size, total - start)
            table[start:start + n] = chunk[:n].float()
    return table
