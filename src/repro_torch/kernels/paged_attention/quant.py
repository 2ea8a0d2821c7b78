"""Symmetric per-row int8 page quantization — the slow-tier storage format
shared by the serve-layer `PagedKVPool` and the paged-attention kernel's
example inputs, so the conformance tests exercise exactly the
representation the serve path feeds the kernel."""
from __future__ import annotations

import numpy as np


def quantize_page(page: np.ndarray):
    """Symmetric per-row int8 quantization over the last axis.
    page: (..., d) -> (int8 values, float32 scales (..., 1))."""
    amax = np.abs(page).astype(np.float32).max(axis=-1, keepdims=True)
    scale = np.where(amax > 0, amax / 127.0, 1.0)
    q = np.clip(np.rint(page.astype(np.float32) / scale), -127, 127)
    return q.astype(np.int8), scale.astype(np.float32)


def dequantize_page(q: np.ndarray, scale: np.ndarray, dtype=np.float32):
    return (q.astype(np.float32) * scale).astype(dtype)
