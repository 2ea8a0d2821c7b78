"""KernelSpec for the Mamba2 SSD chunked scan.

The validation cases, tolerance and input generator are copies of the
JAX package's ``repro/kernels/ssd_scan/spec.py`` (the decode-shaped
S = 1 and S = 4 cases included), so that the CPU tests and
`chip_smoke.py` hold the kernel to the same cases (all of which take the
simt route: their P and N are below the wgmma route's). The tune space
is the wgmma route's ``chunk`` (the reference's name): 64 or 128
positions (`ssd_scan.WGMMA_CHUNKS`), 128 the launch before tiles. The
simt route keeps its chunks of `ssd_scan.CHUNK` and reads no tile; its
cost is flat in it. `ssd_cost` is the Hopper model the knee is taken
from; `work` does not depend on the tile.

`work` is the function's work, the same for every route and for the
plain version: x, B, C, dt, a, y and the final state each once, and the
products of the chunked form over the causal half of each chunk. The
cost counter (`repro_torch.core.hlo_cost`) records it for each call and
`chip_smoke.py` bounds the kernel by it.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.autotune import (HBM_BW, LAUNCH_OVERHEAD_S,
                                       PEAK_FLOPS, TENSOR_BF16_FLOPS)
from repro_torch.kernels import registry
from repro_torch.kernels.api import KernelCase, KernelSpec
from repro_torch.kernels.ssd_scan import ref
from repro_torch.kernels.ssd_scan.ssd_scan import (CHUNK, WGMMA_CHUNK,
                                                   WGMMA_CHUNKS,
                                                   WGMMA_HEAD_DIM,
                                                   WGMMA_PIECES,
                                                   WGMMA_STATES, ssd_scan)

DEFAULT_SHAPE = {"B": 2, "S": 64, "H": 4, "P": 16, "G": 1, "N": 8}
# the main path's hybrid prefill: mamba2-780m, one 2048-token prompt
BENCH_SHAPE = {"B": 1, "S": 2048, "H": 48, "P": 64, "G": 1, "N": 128}
TUNE_SPACE = {"chunk": WGMMA_CHUNKS}
# Fitted by `tools/serve_fit.py` to the kernel phase's tile sweeps on an
# H100 80GB HBM3 at 700 W (log(estimate / measured) by least squares over
# both chunks of every swept grid): the share of the tensor-core rate the
# wgmma route's small products reach, and one chunk's step of the
# in-order state pass (an fp32 FMA chain with 8 chunks' loads in flight).
SSD_TENSOR_SHARE = 0.242
PASS_STEP_S = 1.77e-6


def ssd_cost(grid_shape, tile: dict, dtype_bytes: int) -> tuple | None:
    """(shared bytes of the chunk-scan block, estimated seconds). wgmma
    route (bf16, P = 64, N = 64 or 128), chunks of Q = ``chunk``: the
    longer of the bytes (x, B and C read by two launches, dt, y, and the
    (P, N) chunk states written, read and written by the state pass and
    read again) at the memory rate and the tensor-core products (chunk
    states, C B^T, scores times x, C h_prev, each in `WGMMA_PIECES` bf16
    pieces) at `SSD_TENSOR_SHARE` of the bf16 rate; plus the state
    pass's chain of chunks and three launches. None for a chunk the
    route does not build. The simt route reads no tile: its bytes and
    flops at the fp32 rate, the same for every tile."""
    B, S, H, P, G, N = grid_shape
    io = B * S * ((H * P + 2 * G * N) * dtype_bytes * 2 + H * 4 * 2
                  + H * P * 4)
    if dtype_bytes != 2 or P != WGMMA_HEAD_DIM or N not in WGMMA_STATES:
        flops = 2 * B * H * S * (CHUNK * (N + P) + 2 * N * P)
        return 0, max(io / HBM_BW, flops / PEAK_FLOPS) + LAUNCH_OVERHEAD_S
    q = tile["chunk"]
    if q not in WGMMA_CHUNKS:
        return None
    nc = -(-S // q)
    states = 4 * B * nc * H * P * N * 4
    products = 2 * B * H * nc * WGMMA_PIECES * (
        2 * q * P * N + q * q * N + q * q * P)
    alias = WGMMA_PIECES * P <= q
    smem = (1024 + 2 * q * N * 2 + q * P * 2 + 2 * q * 4
            + (0 if alias else WGMMA_PIECES * P * N * 2))
    t = max((io + states) / HBM_BW,
            products / (SSD_TENSOR_SHARE * TENSOR_BF16_FLOPS))
    return smem, t + nc * PASS_STEP_S + 3 * LAUNCH_OVERHEAD_S


def _grid_of(x, b_mat, *rest):
    B, S, H, P = x.shape
    return B, S, H, P, b_mat.shape[2], b_mat.shape[3]


def work(x, b_mat, c_mat, dt, a, bf16_intra: bool = False) -> dict:
    """{"bytes", "flops": {rate class: flops}} of one call. Bytes: the
    five inputs, y and the final state (fp32), each once. Flops: the
    multiply-adds of the chunked form at chunk Q = `CHUNK` over the
    causal half of each chunk (pairs j <= i): C Bt once per group (on
    the tensor cores, "bf16", when B and C are bf16), and at "fp32" the
    scores times x per head, C exp(cum) @ state per head in every chunk
    but the first (whose incoming state is zero) and the state update
    per head with its per-chunk decay; the O(pairs x H) decay weights
    are left out. With ``bf16_intra`` the scores times x run on the
    tensor cores in one bf16 piece each: "bf16"."""
    B, S, H, P = x.shape
    G, N = b_mat.shape[2], b_mat.shape[3]
    nbytes = sum(t.numel() * t.element_size()
                 for t in (x, b_mat, c_mat, dt, a)) \
        + (B * S * H * P + B * H * P * N) * 4
    q = min(CHUNK, S)
    lens = [min(q, S - i) for i in range(0, S, q)]
    pairs = sum(n * (n + 1) // 2 for n in lens)
    cb = 2 * B * G * pairs * N
    intra = B * H * 2 * pairs * P
    fp32 = B * H * (2 * (S - lens[0]) * N * P + 2 * S * N * P
                    + len(lens) * N * P)
    flops = {"bf16": 0, "fp32": fp32}
    flops["bf16" if bf16_intra else "fp32"] += intra
    flops["bf16" if b_mat.dtype in (torch.bfloat16, torch.float16)
          else "fp32"] += cb
    return {"bytes": nbytes, "flops": {k: v for k, v in flops.items()
                                       if v}}


def example_inputs(shape=None, dtype=np.float32, seed: int = 0) -> dict:
    s = {**DEFAULT_SHAPE, **(shape or {})}
    B, S, H, P, G, N = (s[k] for k in ("B", "S", "H", "P", "G", "N"))
    rng = np.random.default_rng(seed)
    return {
        "x": rng.normal(size=(B, S, H, P)).astype(dtype),
        "b_mat": (rng.normal(size=(B, S, G, N)) * 0.5).astype(dtype),
        "c_mat": (rng.normal(size=(B, S, G, N)) * 0.5).astype(dtype),
        "dt": np.log1p(np.exp(rng.normal(size=(B, S, H)))).astype(dtype),
        "a": (-np.exp(rng.uniform(0.0, 1.0, size=(H,)))).astype(dtype),
    }


SPEC = registry.register(KernelSpec(
    name="ssd_scan",
    fn=ssd_scan,
    ref_fn=ref.ssd_chunked,
    arg_names=("x", "b_mat", "c_mat", "dt", "a"),
    example_inputs=example_inputs,
    tol={"float32": 2e-4},
    cases=(
        KernelCase({"B": 2, "S": 64, "H": 4, "P": 16, "G": 1, "N": 8}),
        KernelCase({"B": 1, "S": 128, "H": 4, "P": 32, "G": 2, "N": 16}),
        KernelCase({"B": 2, "S": 64, "H": 6, "P": 8, "G": 3, "N": 8}),
        # decode-shaped steps (the serve path's per-token shapes)
        KernelCase({"B": 4, "S": 1, "H": 4, "P": 16, "G": 1, "N": 8}),
        KernelCase({"B": 1, "S": 4, "H": 4, "P": 16, "G": 2, "N": 8}),
    ),
    tune_space=TUNE_SPACE,
    cost_fn=ssd_cost,
    grid_of=_grid_of,
    shape_keys=("B", "S", "H", "P", "G", "N"),
    fixed_tile=lambda grid: {"chunk": WGMMA_CHUNK},
    default_shape=DEFAULT_SHAPE,
    bench_shape=BENCH_SHAPE,
    dtypes=("float32", "bfloat16"),
))
