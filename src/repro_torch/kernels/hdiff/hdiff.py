"""COSMO horizontal diffusion: the wrapper of the CUDA kernel in
``csrc/hdiff.cu``.

On CUDA tensors `hdiff` checks its arguments, allocates the output and
launches the kernel on the current stream at the given tile, or raises:
there is no fallback. On CPU tensors it runs the plain version
(`repro_torch.kernels.hdiff.ref.hdiff`), and the tile has no effect.
``hdiff.launches`` counts kernel launches and ``hdiff.plain_calls`` the
calls that went to the plain version because the tensor lay on the CPU.

The tile is the kernel's launch shape: a block of ``tile_x`` x
``tile_y`` threads covers that patch of ``block_z`` planes, with the
patch and its 2-cell halo held in shared memory.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core.autotune import MAX_THREADS, SMEM_BYTES
from repro_torch.kernels.hdiff import ref


@functools.cache
def _lib():
    from repro_torch.kernels.build import load
    lib = load("hdiff")
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    lib.hdiff_launch.argtypes = [vp, vp] + [i32] * 6 + [ctypes.c_float, i32,
                                                        vp]
    lib.hdiff_launch.restype = i32
    lib.hdiff_error_string.argtypes = [i32]
    lib.hdiff_error_string.restype = ctypes.c_char_p
    return lib


def smem_bytes(tile_x: int, tile_y: int, block_z: int) -> int:
    """Shared memory of one block: its fp32 patch plus halo, all planes."""
    return block_z * (tile_y + 2 * ref.HALO) * (tile_x + 2 * ref.HALO) * 4


def hdiff(src, coeff: float = ref.COEFF, *, tile_x: int = 32,
          tile_y: int = 16, block_z: int = 1):
    """src: (nz, ny, nx) float32 or bfloat16 -> the same, as `ref.hdiff`."""
    if not src.is_cuda:
        hdiff.plain_calls += 1
        return ref.hdiff(src, coeff)
    if src.ndim != 3 or src.numel() == 0:
        raise ValueError(f"src {tuple(src.shape)}: expected a non-empty "
                         f"(nz, ny, nx) grid")
    if src.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"src {src.dtype}: the kernel takes float32 or "
                        f"bfloat16")
    if not src.is_contiguous():
        raise ValueError("src must be contiguous")
    if min(tile_x, tile_y, block_z) < 1 or tile_x * tile_y > MAX_THREADS \
            or smem_bytes(tile_x, tile_y, block_z) > SMEM_BYTES:
        raise ValueError(f"tile ({tile_x}, {tile_y}, {block_z}): a block "
                         f"takes at most {MAX_THREADS} threads and "
                         f"{SMEM_BYTES} bytes of shared memory")
    nz, ny, nx = src.shape
    out = torch.empty_like(src)
    lib = _lib()
    with torch.cuda.device(src.device):
        err = lib.hdiff_launch(
            src.data_ptr(), out.data_ptr(), nz, ny, nx, tile_x, tile_y,
            block_z, coeff, int(src.dtype == torch.bfloat16),
            torch.cuda.current_stream(src.device).cuda_stream)
    if err:
        raise RuntimeError(f"hdiff kernel launch failed: "
                           f"{lib.hdiff_error_string(err).decode()}")
    hdiff.launches += 1
    return out


hdiff.launches = 0
hdiff.plain_calls = 0
