"""Paged decode attention: KV reads scale with live context.

The KV cache is a shared pool of ``BLOCK_TOKENS``-token blocks; every
sequence owns a block table listing the physical blocks that hold its
context in logical order.  ``paged_attention`` launches the CUDA kernels
in ``csrc/paged_attention.cu`` for CUDA tensors and runs
``paged_attention_ref``, its plain version, for CPU tensors.

Two forms, as in the reference: grouped-query attention with its own
value pool (kernel #6, replacing ``repro/kernels/paged_attention.py::
_paged_kernel_kv``), and the fused-V form of absorbed MLA
(``v_pool=None, v_dim=r``: the values are the first ``r`` lanes of each
key row, the pool holding ``concat(c_kv, k_rope)``; kernel #7, replacing
``_paged_kernel``).  Both split each sequence into its logical blocks
(one CUDA block per live (sequence, block, head group), partials in an
f32 workspace) and merge the partials in block order in a second kernel.
The fused form takes the route ``fused_route`` names: ``"wgmma"`` (TMA
and ``wgmma`` over 64 query heads a block) for bfloat16 at geometries
like deepseek-v3's, ``"simt"`` (the CUDA-core kernel of the GQA form)
otherwise.  The launches of each form are counted apart,
``paged_attention.launches`` (#6) and ``paged_attention.fused_launches``
(#7, by route in ``paged_attention.fused_launches_by_route``), once per
call.

The operand contract (``_check_operands``: devices, dtypes, contiguity,
alignment) is checked on every device, so a CPU call refuses what the
card refuses; the kernels' geometry limits (``_check_kernel_geometry``)
are the card route's own.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional

import torch

from repro_torch.configs.base import MXU_TILE
from repro_torch.kernels import _build, _mark
from repro_torch.kernels.bsmm import GeometryError

#: tokens per KV block — one crossbar tile edge, like the bsmm tile
BLOCK_TOKENS = MXU_TILE

_NEG = -1e30    # finite mask value (matches models.attention.attend)
_GB = 8         # query heads per block of the CUDA kernel (a head group)
_THREADS = 256  # threads per block of the CUDA kernel
_SMEM_LIMIT = 232448    # shared memory one block may take on the H100
#: the fused form's route codes (csrc/paged_attention.cu)
_FUSED_ROUTES = {"simt": 0, "wgmma": 1}
_WG_HEADS = 64          # query heads a block of the fused wgmma kernel
_WG_CHUNK = 64          # lanes a 128-byte swizzled row


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
    """Plain version of kernels #6 and #7: gather the table rows,
    single-pass masked softmax in f32 — the grouped math
    ``models.attention.attend`` uses.  With ``v_pool=None`` the values
    are the first ``v_dim`` lanes of the gathered keys.

    Keys and values past each length are zeroed before use, so dead
    pool contents (even NaN) never reach the output; on finite pools
    this is the reference's ``paged_attention_ref`` exactly."""
    geo = _check_geometry(q, k_pool, v_pool, tables, lengths, v_dim)
    k = paged_gather(k_pool, tables)                  # (B, L, Hkv, hd)
    v = k[..., :geo.dv] if v_pool is None else paged_gather(v_pool, tables)
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


def fused_wgmma_smem_bytes(hd: int) -> int:
    """Dynamic shared memory of a block of the fused form's ``wgmma``
    kernel at head width ``hd``: per 64-lane chunk of hd, q's 64 heads
    (8 KB) and the pool block's 128 rows (16 KB), both 128-byte
    swizzled, and one 8-byte mbarrier; the two warpgroups' row maxima
    and sums (1 KB f32); 1 KB to align the base to the swizzle atom."""
    hc = -(-hd // _WG_CHUNK)
    return hc * (_WG_HEADS * 128 + BLOCK_TOKENS * 128 + 8) + 4 * 2 * 2 \
        * _WG_HEADS + 1024


def fused_route(geo: PagedGeometry, dtype: torch.dtype) -> str:
    """Which CUDA kernel computes the fused-V form (#7), by the name
    ``paged_attention.fused_launches_by_route`` counts it under:
    ``"wgmma"`` for bfloat16 with the query heads of a KV head a multiple
    of 64, hd a multiple of 64 whose q and K chunks fit one block's
    shared memory (hd <= 576), dv a multiple of 128 up to min(512, hd)
    (each of two warpgroups owns dv / 2 value lanes) and 128-token
    blocks; ``"simt"`` (the CUDA-core kernel) otherwise."""
    G = geo.Hq // geo.Hkv
    if (dtype == torch.bfloat16 and G % _WG_HEADS == 0
            and geo.hd % _WG_CHUNK == 0 and geo.dv % (2 * _WG_CHUNK) == 0
            and geo.dv <= min(512, geo.hd) and geo.T == BLOCK_TOKENS
            and fused_wgmma_smem_bytes(geo.hd) <= _SMEM_LIMIT):
        return "wgmma"
    return "simt"


def _check_kernel_geometry(geo: PagedGeometry, elem: int,
                           fused: bool = False, route: str = "simt") -> None:
    """What the CUDA kernels take (see csrc/paged_attention.cu): the GQA
    form stages a pool block's K and V rows in shared memory beside the
    f32 state of a head group; the fused form's CUDA-core kernel keeps
    only the state, its ``wgmma`` kernel q's heads and the block's rows
    (``fused_wgmma_smem_bytes``)."""
    if route == "wgmma":
        smem = fused_wgmma_smem_bytes(geo.hd)
        if smem > _SMEM_LIMIT:
            raise GeometryError(
                f"the fused wgmma kernel needs {smem} bytes of shared "
                f"memory, over {_SMEM_LIMIT}", shape=(geo.hd, geo.dv),
                where="paged_attention")
        return
    g = min(geo.Hq // geo.Hkv, _GB)
    # the p @ v pass: dv / 2 threads a token group, as many whole groups
    # as the block's threads hold (the rest idle in that pass)
    tg = _THREADS // (geo.dv // 2) if geo.dv >= 2 else 0
    vec = 16 // elem
    smem = 4 * (g * (geo.hd + geo.T) + tg * g * geo.dv + 2 * g)
    if not fused:
        smem += elem * geo.T * (geo.hd + geo.dv)
    if (geo.hd % vec or geo.T % 32 or geo.dv % 2
            or (not fused and geo.dv % vec)
            or geo.dv > 2 * _THREADS or smem > _SMEM_LIMIT):
        raise GeometryError(
            f"the CUDA kernel takes hd (and, with a value pool, dv) a "
            f"multiple of {vec}, T a multiple of 32, an even dv <= "
            f"{2 * _THREADS} and <= {_SMEM_LIMIT} bytes of shared memory "
            f"(needs {smem})",
            shape=(geo.Hq // geo.Hkv, geo.hd, geo.T, geo.dv),
            where="paged_attention")


def _check_operands(q, k_pool, v_pool, tables, lengths) -> None:
    """The kernel's operand contract, checked on every device: one
    device, q and the pools in one of float32 or bfloat16, int32 tables
    and lengths, contiguous operands, 16-byte aligned q and pools."""
    pools = (k_pool,) if v_pool is None else (k_pool, v_pool)
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool),
                    ("tables", tables), ("lengths", lengths)):
        if t is not None and t.device != q.device:
            raise ValueError(f"paged_attention: {name} on {t.device}, q on "
                             f"{q.device}")
    if q.dtype not in _DTYPE_CODES or any(t.dtype != q.dtype for t in pools):
        raise TypeError("paged_attention: q and the pools must share float32 "
                        "or bfloat16")
    if tables.dtype != torch.int32 or lengths.dtype != torch.int32:
        raise TypeError("paged_attention: tables and lengths must be int32")
    if not all(t.is_contiguous() for t in (q, *pools, tables, lengths)):
        raise ValueError("paged_attention: operands must be contiguous")
    if any(t.data_ptr() % 16 for t in (q, *pools)):
        raise ValueError("paged_attention: q and the pools must be 16-byte "
                         "aligned")


@functools.lru_cache(maxsize=None)
def _lib():
    lib = _build.library("paged_attention")
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.paged_attention_launch.argtypes = [vp, vp, vp, vp, vp, vp, vp, i, i, i,
                                           i, i, i, i, i, ctypes.c_float, i,
                                           i, vp]
    lib.paged_attention_launch.restype = i
    return lib


_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


@_mark.marked
def paged_attention(q, k_pool, v_pool, tables, lengths, *,
                    scale: float, v_dim: Optional[int] = None):
    """Paged decode attention over a block pool (kernel #6, or #7 with
    ``v_pool=None``).

    q:        (B, Hq, hd) — one query per sequence
    k_pool:   (P, T, Hkv, hd) — the shared physical block pool
    v_pool:   (P, T, Hkv, dv), or None with ``v_dim=dv <= hd`` for the
              fused MLA form (values = ``k_pool[..., :dv]``)
    tables:   (B, NB) int32 — physical block per logical block; entries
              past a sequence's live blocks must still be valid pool ids
              (the engine points them at its scratch block)
    lengths:  (B,) int32 — live context per sequence including the
              just-appended token; must be >= 1

    Returns (B, Hq, dv) in q's dtype.
    """
    geo = _check_geometry(q, k_pool, v_pool, tables, lengths, v_dim)
    _check_operands(q, k_pool, v_pool, tables, lengths)
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_pool, v_pool, tables, lengths,
                                   scale=scale, v_dim=v_dim)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    fused = v_pool is None
    route = fused_route(geo, q.dtype) if fused else "simt"
    _check_kernel_geometry(geo, q.element_size(), fused=fused, route=route)
    lib = _lib()
    out = torch.empty((geo.B, geo.Hq, geo.dv), dtype=q.dtype, device=q.device)
    # the partials (acc, m, l) of every (sequence, head, logical block)
    part = torch.empty((geo.B, geo.Hq, geo.NB, geo.dv + 2),
                       dtype=torch.float32, device=q.device)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    code = lib.paged_attention_launch(
        q.data_ptr(), k_pool.data_ptr(),
        None if v_pool is None else v_pool.data_ptr(), tables.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), part.data_ptr(), geo.B, geo.Hq,
        geo.Hkv, geo.hd, geo.dv, geo.T, geo.NB, geo.P, float(scale),
        _DTYPE_CODES[q.dtype], _FUSED_ROUTES[route], stream)
    _build.check(lib, code, "paged_attention")
    if fused:
        paged_attention.fused_launches += 1
        paged_attention.fused_launches_by_route[route] += 1
    else:
        paged_attention.launches += 1
    return out


paged_attention.launches = 0          # kernel #6, the GQA form
paged_attention.fused_launches = 0    # kernel #7, the fused-V form
#: #7's launches by the kernel that ran (``fused_route``'s names)
paged_attention.fused_launches_by_route = {k: 0 for k in _FUSED_ROUTES}
