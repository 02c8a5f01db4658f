"""Flash attention for serving prefill: causal or full, grouped-query.

Kernel #8 of the port, replacing ``repro/kernels/flash_attention.py::
_flash_kernel``.  ``flash_attention`` launches a CUDA kernel of
``csrc/flash_attention.cu`` for CUDA tensors and runs
``flash_attention_plain``, its plain version, for CPU tensors; any other
device raises.  The route on the card is chosen by dtype, in the open:
bfloat16 operands go to the Hopper kernel (TMA-fed, warp-specialised,
both products on ``wgmma``; p rounded to bf16 for ``p @ v``), float32
operands to the CUDA-core kernel (f32 throughout, as the reference).
Both compute what the TPU kernel computes: scores scaled by
``1/sqrt(hd)`` of q's width, masked positions at the finite ``-1e30``,
an online softmax in float32, the output in q's dtype.  Query head ``h``
reads KV head ``h // (Hq // Hkv)``.  Beyond the TPU kernel's grid they
take any ``S >= 1`` and a value width ``dv <= hd`` (MLA prefill), up to
``hd = dv = 256`` (recurrentgemma's local attention).

The operand contract (device agreement, one dtype of float32 or
bfloat16, contiguity) is checked on every device, so a CPU run refuses
what the card refuses; the width limits of the kernels
(``kernel_widths``, ``wgmma_geometry``) are checked on the card route
only.  Launches are counted in ``flash_attention.launches`` and, per
route, in ``flash_attention.launches_by_route``.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import _build, _mark
from repro_torch.kernels.bsmm import GeometryError

_NEG = -1e30        # finite mask value (matches models.attention.attend)
_MAX_HD = 256       # widths the CUDA kernels take (csrc/flash_attention.cu)
_MAX_DV = 256
_PLAIN_BLOCK_Q = 512    # query rows per score block of the plain version
# dtype -> the card route that takes it
_ROUTES = {torch.float32: "simt", torch.bfloat16: "wgmma"}


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


def kernel_widths(hd: int, dv: int) -> None:
    """The widths both CUDA kernels take: ``hd <= 256`` and
    ``dv <= 256`` (the float32 kernel's shared memory holds two
    transposed (hd, 68) tiles, a (64, 68) tile of p and a (64, 16
    ceil(dv / 16)) value tile: 222,208 bytes at hd = dv = 256)."""
    if hd > _MAX_HD or dv > _MAX_DV:
        raise GeometryError(f"the CUDA kernels take hd <= {_MAX_HD} and "
                            f"dv <= {_MAX_DV}", shape=(hd, dv),
                            where="flash_attention")


def wgmma_geometry(q, k, v) -> None:
    """What the bfloat16 (TMA and wgmma) kernel takes beyond
    ``kernel_widths``: TMA reads each operand as a 4-D map (d, head, S,
    B) whose strides must be multiples of 16 bytes and whose base must
    be 16-byte aligned.  So it excludes

    - a head width ``hd`` or a value width ``dv`` that is not a multiple
      of 8 elements (then the row strides ``Hq*hd``, ``Hkv*hd`` and
      ``Hkv*dv`` need not be either);
    - q, k or v starting off a 16-byte boundary (a view at an odd
      offset).

    Every other geometry the float32 kernel takes is taken: any S >= 1,
    any head counts with Hq % Hkv == 0, dv <= hd (ragged S, hd and dv
    below a 64-column chunk are TMA's zero fill)."""
    hd, dv = q.shape[3], v.shape[3]
    kernel_widths(hd, dv)
    if hd % 8 or dv % 8:
        raise GeometryError("the bfloat16 kernel's TMA maps need hd and dv "
                            "multiples of 8 (16-byte strides)",
                            shape=(hd, dv), where="flash_attention")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_attention: the bfloat16 kernel needs q, k "
                         "and v 16-byte aligned (TMA)")


def _check_operands(q, k, v) -> None:
    """The operand contract of both routes, checked on every device."""
    for name, t in (("k", k), ("v", v)):
        if t.device != q.device:
            raise ValueError(f"flash_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _ROUTES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_attention: q, k and v must share float32 or "
                        "bfloat16")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("flash_attention: operands must be contiguous")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("flash_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    for fn in (lib.flash_attention_f32_launch,
               lib.flash_attention_bf16_launch):
        fn.argtypes = [vp, vp, vp, vp, i, i, i, i, i, i, ctypes.c_float, i,
                       vp]
        fn.restype = i
    lib.flash_attention_bf16_smem.argtypes = [i, i]
    lib.flash_attention_bf16_smem.restype = i
    return lib


def wgmma_smem_bytes(hd: int, dv: int) -> int:
    """Dynamic shared memory of the bfloat16 kernel at widths (hd, dv),
    as its launch asks for it (builds the library)."""
    return _lib().flash_attention_bf16_smem(hd, dv)


@_mark.marked
def flash_attention(q, k, v, *, causal: bool = True, bq: int = MXU_TILE,
                    bk: int = MXU_TILE):
    """Flash attention (kernel #8).

    q: (B, S, Hq, hd); k: (B, S, Hkv, hd); v: (B, S, Hkv, dv), dv <= hd
    → (B, S, Hq, dv) in q's dtype.  ``causal`` masks keys after each
    query.  ``bq``/``bk`` keep the reference's signature; the result does
    not depend on them (the CUDA kernels choose their own tiles, and the
    TPU kernel's tiles only reorder exact sums).
    """
    del bq, bk
    B, S, Hq, Hkv, hd, dv = _check_geometry(q, k, v)
    _check_operands(q, k, v)
    if q.device.type == "cpu":
        return flash_attention_plain(q, k, v, causal=causal)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {q.device}")
    route = _ROUTES[q.dtype]
    if route == "wgmma":
        wgmma_geometry(q, k, v)
    else:
        kernel_widths(hd, dv)
    lib = _lib()
    launch = lib.flash_attention_bf16_launch if route == "wgmma" \
        else lib.flash_attention_f32_launch
    out = torch.empty((B, S, Hq, dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                  B, S, Hq, Hkv, hd, dv, 1.0 / math.sqrt(hd),
                  int(bool(causal)), stream)
    _build.check(lib, code, "flash_attention")
    flash_attention.launches += 1
    flash_attention.launches_by_route[route] += 1
    return out


flash_attention.launches = 0
flash_attention.launches_by_route = {"wgmma": 0, "simt": 0}
