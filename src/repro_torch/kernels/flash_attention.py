"""Flash attention for serving prefill: causal or full, grouped-query.

Kernel #8 of the port, replacing ``repro/kernels/flash_attention.py::
_flash_kernel``.  ``flash_attention`` launches the CUDA kernel in
``csrc/flash_attention.cu`` for CUDA tensors and runs
``flash_attention_plain``, its plain version, for CPU tensors; any other
device raises.  Both compute what the TPU kernel computes: q, k and v
read as float32, scores scaled by ``1/sqrt(hd)`` of q's width, masked
positions at the finite ``-1e30``, softmax in float32 (p stays float32
for ``p @ v``), the output in q's dtype.  Query head ``h`` reads KV head
``h // (Hq // Hkv)``.  Beyond the TPU kernel's grid they take any
``S >= 1`` and a value width ``dv <= hd`` (MLA prefill).

Launches of the CUDA kernel are counted in ``flash_attention.launches``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import _build
from repro_torch.kernels.bsmm import GeometryError

_NEG = -1e30        # finite mask value (matches models.attention.attend)
_MAX_HD = 256       # widths the CUDA kernel takes (csrc/flash_attention.cu)
_MAX_DV = 192
_PLAIN_BLOCK_Q = 512    # query rows per score block of the plain version


def _check_geometry(q, k, v):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise GeometryError("q, k, v must be (B, S, H, d)", shape=q.shape,
                            where="flash_attention")
    B, S, Hq, hd = q.shape
    if tuple(k.shape) != (B, S, k.shape[2], hd):
        raise GeometryError("k must be (B, S, Hkv, hd) like q",
                            shape=k.shape, where="flash_attention")
    Hkv, dv = k.shape[2], v.shape[3]
    if tuple(v.shape[:3]) != (B, S, Hkv):
        raise GeometryError("v must be (B, S, Hkv, dv) like k",
                            shape=v.shape, where="flash_attention")
    if S < 1 or Hkv < 1 or Hq % Hkv:
        raise GeometryError(f"needs S >= 1 and Hq={Hq} a multiple of "
                            f"Hkv={Hkv}", shape=q.shape,
                            where="flash_attention")
    if not 0 < dv <= hd:
        raise GeometryError(f"needs 0 < dv <= hd, got dv={dv}, hd={hd}",
                            shape=v.shape, where="flash_attention")
    return B, S, Hq, Hkv, hd, dv


def flash_attention_plain(q, k, v, *, causal: bool = True):
    """Plain version of kernel #8: the same function in float32 with a
    single-pass softmax, one block of query rows at a time (the grouped
    math of ``models.attention.attend``)."""
    B, S, Hq, Hkv, hd, dv = _check_geometry(q, k, v)
    G = Hq // Hkv
    scale = 1.0 / math.sqrt(hd)
    kf, vf = k.float(), v.float()
    kpos = torch.arange(S, device=q.device)
    outs = []
    for i0 in range(0, S, _PLAIN_BLOCK_Q):
        qb = q[:, i0:i0 + _PLAIN_BLOCK_Q].float()
        n = qb.shape[1]
        s = torch.einsum("bqkgd,bskd->bkgqs", qb.reshape(B, n, Hkv, G, hd),
                         kf) * scale
        if causal:
            qpos = i0 + torch.arange(n, device=q.device)
            s = torch.where(kpos[None, :] <= qpos[:, None], s, _NEG)
        w = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgqs,bskd->bqkgd", w, vf)
        outs.append(o.reshape(B, n, Hq, dv))
    return torch.cat(outs, dim=1).to(q.dtype)


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i,
                                           ctypes.c_float, i, i, vp]
    lib.flash_attention_launch.restype = i
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def flash_attention(q, k, v, *, causal: bool = True, bq: int = MXU_TILE,
                    bk: int = MXU_TILE):
    """Flash attention (kernel #8).

    q: (B, S, Hq, hd); k: (B, S, Hkv, hd); v: (B, S, Hkv, dv), dv <= hd
    → (B, S, Hq, dv) in q's dtype.  ``causal`` masks keys after each
    query.  ``bq``/``bk`` keep the reference's signature; the result does
    not depend on them (the CUDA kernel tiles at 64 x 64, and the TPU
    kernel's tiles only reorder exact sums).
    """
    del bq, bk
    B, S, Hq, Hkv, hd, dv = _check_geometry(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPE_CODES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share float32 or "
                        "bfloat16")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be contiguous")
    if hd > _MAX_HD or dv > _MAX_DV:
        raise GeometryError(f"the CUDA kernel takes hd <= {_MAX_HD} and "
                            f"dv <= {_MAX_DV}", shape=(hd, dv),
                            where="flash_attention")
    lib = _lib()
    out = torch.empty((B, S, Hq, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.flash_attention_launch(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S, Hq,
        Hkv, hd, dv, 1.0 / math.sqrt(hd), int(bool(causal)),
        _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
