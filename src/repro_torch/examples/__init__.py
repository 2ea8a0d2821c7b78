"""The JAX package's ``examples/`` scripts on the port, one module each,
run as ``python -m repro_torch.examples.<name>``:

- ``serve_stream``: the async front end, a cancel and the metrics summary;
- ``serve_lm``: Sibyl placement, the decode trace's replay through the
  HSS simulator and k = 4 speculative decode;
- ``quickstart``: train, checkpoint, serve;
- ``train_100m``: a ~135M-parameter LM under the restart supervisor.

The other two examples have their counterparts in ``launch/``:
``weather_stencil.py`` and ``sibyl_storage.py``. Each module runs on the
card unless ``--device cpu`` is given, and its ``main(argv=None, *,
params=None)`` returns what the script prints.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch.train.trainer import Trainer


def parser(doc: str) -> argparse.ArgumentParser:
    """An example's argument parser with the ``--device`` flag."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    return ap


def check_device(device: str) -> None:
    """Refuse to start on ``cuda`` without a card: an example never
    carries on on the CPU unless asked to."""
    if device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device: pass --device cpu to run on the "
                         "CPU")


def trainer(cfg, oc, job, device, params=None) -> Trainer:
    """`Trainer(cfg, oc, job, device=device)` whose model starts from
    `params` (a flat state dict) instead of its seeded weights; a
    checkpoint in ``job.checkpoint_dir`` still takes precedence."""
    tr = Trainer(cfg, oc, job, device=device)
    if params is not None:
        with torch.no_grad():
            for name, p in tr.model.weights.named_parameters():
                p.copy_(torch.as_tensor(params[name]))
    return tr
