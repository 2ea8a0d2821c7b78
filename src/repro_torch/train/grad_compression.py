"""int8 error-feedback gradient compression — the port of the JAX
package's ``repro/train/grad_compression.py`` at one device.

``make_error_feedback_compressor`` is a ``grad_transform`` hook for
`repro_torch.train.train_step.make_train_step`: each gradient leaf
(plus the residual carried from the last step) is quantized to int8 with
one symmetric per-leaf scale, the dequantized value replaces the
gradient and what quantization lost carries to the next step (error
feedback keeps SGD unbiased in the long run). The reference's wire-level
``compressed_psum`` needs a device mesh, which the port does not have
yet.
"""
from __future__ import annotations

import torch


def quantize_int8(x):
    """Symmetric int8 with one scale: ``(q int8, scale fp32 scalar)``,
    scale ``max |x| / 127`` (1 for an all-zero x)."""
    amax = torch.max(torch.abs(x))
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax))
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.to(torch.float32) * scale


def make_error_feedback_compressor():
    """grad_transform(grads, state) -> (compressed grads, new state), over
    flat ``{name: tensor}`` dicts; the state is the fp32 residual."""

    def transform(grads: dict, state):
        if state is None:
            state = {n: torch.zeros(g.shape, dtype=torch.float32,
                                    device=g.device)
                     for n, g in grads.items()}
        new_g, new_state = {}, {}
        for name, g in grads.items():
            total = g.to(torch.float32) + state[name]
            q, scale = quantize_int8(total)
            deq = dequantize_int8(q, scale)
            new_g[name] = deq.to(g.dtype)
            new_state[name] = total - deq
        return new_g, new_state

    return transform
