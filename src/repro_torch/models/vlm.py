"""Qwen2-VL backbone helpers.

The vision frontend is a stub, as in the JAX package: callers give
precomputed ``inputs_embeds`` (patch embeddings already merged with token
embeddings) to ``EmbedsLM.prefill``. This module builds the M-RoPE position
ids of a sequence that holds an image; the backbone itself is
``transformer.forward`` with ``inputs_embeds`` and ``pos="mrope"``.
"""
from __future__ import annotations

import numpy as np
import torch


def mrope_positions_with_image(batch: int, seq: int, image_start: int, grid_h: int, grid_w: int,
                               device=None) -> torch.Tensor:
    """(3, B, S) int32 positions on ``device``: text ranks advance
    temporally; the image span of grid_h x grid_w tokens at ``image_start``
    gets one temporal index and spatial (h, w) coordinates; the trailing
    text resumes after the largest position so far (Qwen2-VL, section 2.1)."""
    n_img = grid_h * grid_w
    if image_start + n_img > seq:
        raise ValueError(f"an image of {n_img} tokens at {image_start} does not fit {seq} tokens")
    t = np.zeros(seq, np.int32)
    h = np.zeros(seq, np.int32)
    w = np.zeros(seq, np.int32)
    t[:image_start] = h[:image_start] = w[:image_start] = np.arange(image_start)
    t[image_start:image_start + n_img] = image_start
    hh, ww = np.meshgrid(np.arange(grid_h), np.arange(grid_w), indexing="ij")
    h[image_start:image_start + n_img] = image_start + hh.reshape(-1)
    w[image_start:image_start + n_img] = image_start + ww.reshape(-1)
    nxt = image_start + max(grid_h, grid_w)
    tail = seq - image_start - n_img
    if tail > 0:
        for arr in (t, h, w):
            arr[image_start + n_img:] = nxt + np.arange(tail)
    pos = np.broadcast_to(np.stack([t, h, w])[:, None, :], (3, batch, seq))
    return torch.from_numpy(pos.copy()).to(device)
