"""PyTorch/CUDA port of the JAX serving stack in ``repro``.

The package mirrors ``repro``'s module names so that each counterpart is
easy to find, imports ``torch`` and never ``jax``, and imports nothing of
``repro``: what it needs from there it keeps as its own copy. Entry
points run on ``cuda`` unless the caller passes ``device="cpu"``; on CPU
tensors every kernel wrapper uses its plain PyTorch version.
"""
