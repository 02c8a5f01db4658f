"""Paged decode attention: KV reads scale with live context.

The KV cache is a shared pool of ``BLOCK_TOKENS``-token blocks; every
sequence owns a block table listing the physical blocks that hold its
context in logical order.  ``paged_attention`` launches the CUDA kernel
in ``csrc/paged_attention.cu`` (it replaces the Pallas TPU kernel
``repro/kernels/paged_attention.py::_paged_kernel_kv``) for CUDA tensors
and runs ``paged_attention_ref``, its plain version, for CPU tensors;
``paged_attention.launches`` counts kernel launches.

Only the grouped-query form with its own value pool is ported; the MLA
fused-V form (``v_pool=None``) raises until the MLA slice.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import _build
from repro_torch.kernels.bsmm import GeometryError

#: tokens per KV block — one crossbar tile edge, like the bsmm tile
BLOCK_TOKENS = MXU_TILE

_NEG = -1e30    # finite mask value (matches models.attention.attend)
_MAX_G = 16     # query heads per KV head the CUDA kernel takes
_THREADS = 256  # threads per block of the CUDA kernel
_SMEM_LIMIT = 48 * 1024


class PagedGeometry(NamedTuple):
    """Validated shapes for one paged-attention call."""
    B: int
    Hq: int
    hd: int
    Hkv: int
    T: int          # tokens per block
    NB: int         # table width (logical blocks per sequence)
    P: int          # physical blocks in the pool
    dv: int         # value head dim


def _check_geometry(q, k_pool, v_pool, tables, lengths,
                    v_dim: Optional[int]) -> PagedGeometry:
    if q.ndim != 3:
        raise GeometryError("q must be (B, Hq, hd)", shape=q.shape,
                            where="paged_attention")
    if k_pool.ndim != 4:
        raise GeometryError("k_pool must be (P, T, Hkv, hd)",
                            shape=k_pool.shape, where="paged_attention")
    B, Hq, hd = q.shape
    P, T, Hkv, hdk = k_pool.shape
    if hdk != hd:
        raise GeometryError("q/k head dims disagree", shape=(hd, hdk),
                            where="paged_attention")
    if Hq % Hkv:
        raise GeometryError(f"Hq={Hq} not a multiple of Hkv={Hkv}",
                            where="paged_attention")
    if tables.ndim != 2 or tables.shape[0] != B:
        raise GeometryError("tables must be (B, NB)", shape=tables.shape,
                            where="paged_attention")
    if tuple(lengths.shape) != (B,):
        raise GeometryError("lengths must be (B,)", shape=lengths.shape,
                            where="paged_attention")
    if v_pool is None:
        if v_dim is None or not (0 < v_dim <= hd):
            raise GeometryError(
                f"v_pool=None needs 0 < v_dim <= hd, got v_dim={v_dim}",
                shape=(hd,), where="paged_attention")
        dv = v_dim
    else:
        if tuple(v_pool.shape[:3]) != (P, T, Hkv):
            raise GeometryError("k_pool/v_pool pools disagree",
                                shape=v_pool.shape, where="paged_attention")
        dv = v_pool.shape[3]
    return PagedGeometry(B=B, Hq=Hq, hd=hd, Hkv=Hkv, T=T,
                         NB=tables.shape[1], P=P, dv=dv)


def _fused_v_not_ported():
    return NotImplementedError("the fused-V (MLA) paged attention form is "
                               "not yet ported")


def paged_gather(pool, tables):
    """pool (P, T, ...) × tables (B, NB) → (B, NB*T, ...) in logical
    token order: token ``t`` of sequence ``b`` is
    ``pool[tables[b, t // T], t % T]``."""
    B, NB = tables.shape
    T = pool.shape[1]
    dense = pool[tables.long()]
    return dense.reshape(B, NB * T, *pool.shape[2:])


def paged_attention_ref(q, k_pool, v_pool, tables, lengths, *,
                        scale: float, v_dim: Optional[int] = None):
    """Plain version of kernel #6: gather the table rows, single-pass
    masked softmax in f32 — the grouped math ``models.attention.attend``
    uses.

    Keys and values past each length are zeroed before use, so dead
    pool contents (even NaN) never reach the output; on finite pools
    this is the reference's ``paged_attention_ref`` exactly."""
    geo = _check_geometry(q, k_pool, v_pool, tables, lengths, v_dim)
    if v_pool is None:
        raise _fused_v_not_ported()
    k = paged_gather(k_pool, tables)                  # (B, L, Hkv, hd)
    v = paged_gather(v_pool, tables)
    B, L = k.shape[0], k.shape[1]
    G = geo.Hq // geo.Hkv
    valid = (torch.arange(L, device=q.device)[None]
             < lengths.to(q.device).long()[:, None])           # (B, L)
    keep = valid[:, :, None, None]
    k = torch.where(keep, k.float(), 0.0)
    v = torch.where(keep, v.float(), 0.0)
    qg = q.float().reshape(B, geo.Hkv, G, geo.hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg, k) * scale
    s = torch.where(valid[:, None, None], s, _NEG)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", w, v)
    return o.reshape(B, geo.Hq, geo.dv).to(q.dtype)


def _check_kernel_geometry(geo: PagedGeometry, elem: int) -> None:
    """What the CUDA kernel takes (see csrc/paged_attention.cu)."""
    G = geo.Hq // geo.Hkv
    tg = _THREADS // (geo.dv // 2) if geo.dv >= 2 else 0
    smem = 4 * (G * (geo.hd + geo.T + geo.dv) + tg * G * geo.dv + 3 * G)
    if (G > _MAX_G or geo.hd % (16 // elem) or geo.T % 32 or geo.dv % 2
            or geo.dv > 2 * _THREADS or smem > _SMEM_LIMIT):
        raise GeometryError(
            f"the CUDA kernel takes G <= {_MAX_G}, hd a multiple of "
            f"{16 // elem}, T a multiple of 32, an even dv <= {2 * _THREADS} "
            f"and <= {_SMEM_LIMIT} bytes of shared memory (needs {smem})",
            shape=(G, geo.hd, geo.T, geo.dv), where="paged_attention")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("paged_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [vp, vp, vp, vp, vp, vp, i, i, i, i,
                                           i, i, i, ctypes.c_float, i, vp]
    lib.paged_attention_launch.restype = i
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    scale: float, v_dim: Optional[int] = None):
    """Paged decode attention over a block pool (kernel #6).

    q:        (B, Hq, hd) — one query per sequence
    k_pool:   (P, T, Hkv, hd) — the shared physical block pool
    v_pool:   (P, T, Hkv, dv)
    tables:   (B, NB) int32 — physical block per logical block; entries
              past a sequence's live blocks must still be valid pool ids
              (the engine points them at its scratch block)
    lengths:  (B,) int32 — live context per sequence including the
              just-appended token; must be >= 1

    Returns (B, Hq, dv) in q's dtype.
    """
    geo = _check_geometry(q, k_pool, v_pool, tables, lengths, v_dim)
    if v_pool is None:
        raise _fused_v_not_ported()
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                                   scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPE_CODES or k_pool.dtype != q.dtype \
            or v_pool.dtype != q.dtype:
        raise TypeError("paged_attention: q and the pools must share float32 "
                        "or bfloat16")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: tables and lengths must be int32")
    if not all(t.is_contiguous() for t in (q, k_pool, v_pool, tables,
                                           lengths)):
        raise ValueError("paged_attention: operands must be contiguous")
    _check_kernel_geometry(geo, q.element_size())
    if any(t.data_ptr() % 16 for t in (q, k_pool, v_pool)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned")
    lib = _lib()
    out = torch.empty((geo.B, geo.Hq, geo.dv), dtype=q.dtype, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), geo.B, geo.Hq, geo.Hkv, geo.hd,
        geo.dv, geo.T, geo.NB, float(scale), _DTYPE_CODES[q.dtype], stream)
    _build.check(lib, code, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
