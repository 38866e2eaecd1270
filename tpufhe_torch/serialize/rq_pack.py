"""The Rq residue transcode of the wire codec (codecs.py encode_polys,
decode_polys): m messages' (m, k, N) canonical words to their payloads,
limb i packed little-endian in nbits_i = bitlen(p_i - 1) bits a residue
(Modulus.serialize_vec), the k limbs one after another, and back.

The route is the words' device. On the card the kernels rq_pack and
rq_unpack (csrc/rq_pack.cu) transcode, so only the packed bytes cross
PCIe: one launch and one device-to-host copy a call of ``pack``, one
upload, one launch and the read of its range flag a call of ``unpack``. On
the CPU numpy does (utils/transcode.py through ``pack_plain`` and
``unpack_plain``), which is also the kernels' reference; the plain
versions take words on either device. Both routes give the same bytes and
words, and raise the same errors. The program's counters ``wire.card_rows``
and ``wire.host_rows`` count the messages each route transcodes.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from tpufhe_torch import kernels
from tpufhe_torch.device import on_card
from tpufhe_torch.errors import SerializationError
from tpufhe_torch.utils.obs import count


def pack(ctx, x: torch.Tensor) -> np.ndarray:
    """The (m, row bytes) uint8 payloads of the (m, k, N) canonical words
    x of ctx, on the card by rq_pack where x lies there."""
    if on_card(x):
        count("wire.card_rows", x.shape[0])
        return pack_cuda(ctx, x)
    count("wire.host_rows", x.shape[0])
    return pack_plain(ctx, x)


def unpack(ctx, payloads: list) -> torch.Tensor:
    """The (m, k, N) words on ctx's device of m payloads of ctx (bytes of
    the length encode gives them), on the card by rq_unpack where ctx
    lies there; SerializationError if a residue is not below its
    modulus."""
    if on_card(ctx.device):
        count("wire.card_rows", len(payloads))
        return unpack_cuda(ctx, payloads)
    count("wire.host_rows", len(payloads))
    return unpack_plain(ctx, payloads)


def pack_plain(ctx, x: torch.Tensor) -> np.ndarray:
    """pack by numpy on the host (x copied there first)."""
    mat = x.cpu().numpy()
    return np.concatenate(
        [q.serialize_vec(mat[:, i, :].astype(np.uint64))
         for i, q in enumerate(ctx.q)], axis=-1)


def unpack_plain(ctx, payloads: list) -> torch.Tensor:
    """unpack by numpy on the host, then one upload to ctx's device."""
    buf = np.frombuffer(b"".join(payloads), np.uint8).reshape(
        len(payloads), -1)
    rows, idx = [], 0
    for q in ctx.q:
        ln = q.serialization_length(ctx.degree)
        row = q.deserialize_vec(buf[:, idx:idx + ln])[:, :ctx.degree]
        if (row >= np.uint64(q.p)).any():
            raise SerializationError("Coefficient out of range")
        rows.append(row)
        idx += ln
    mat = np.stack(rows, axis=1)
    words = mat.astype(np.int32 if ctx.narrow else np.int64, order="C")
    return torch.from_numpy(words).to(ctx.device)


# the C entry points' argument types (csrc/rq_pack.cu)
_PACK_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
              ctypes.c_longlong] + [ctypes.c_void_p] * 5
_UNPACK_ARGS = [ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                ctypes.c_longlong] + [ctypes.c_void_p] * 6


@functools.lru_cache(maxsize=64)
def _limbs(moduli: tuple) -> tuple:
    """The nbits and the moduli of a context's moduli as the C arrays the
    entry points take, and the nbits as a list."""
    nbits = [(p - 1).bit_length() for p in moduli]
    return ((ctypes.c_int * len(moduli))(*nbits),
            (ctypes.c_longlong * len(moduli))(*moduli), nbits)


def _row_bytes(nbits: list, degree: int) -> int:
    return sum(nbits) * degree // 8


def pack_cuda(ctx, x: torch.Tensor) -> np.ndarray:
    """pack on the card: rq_pack_cuda, then the packed rows and the
    kernel's flag to the host in one copy. AssertionError where a word is
    wider than its modulus's nbits, as the host transcode raises."""
    host = rq_pack_cuda(ctx, x).cpu().numpy()
    if host[-1]:
        raise AssertionError("a residue wider than its modulus's bits")
    m = x.shape[0]
    total = m * _row_bytes(_limbs(tuple(ctx.moduli))[2], ctx.degree)
    return host[:-1].view(np.uint8)[:total].reshape(m, -1)


def unpack_cuda(ctx, payloads: list) -> torch.Tensor:
    """unpack on the card: the m payloads uploaded in one copy (whole
    8-byte words, then the flag's), rq_unpack_cuda, then its range flag
    read: SerializationError where it is set."""
    nbits = _limbs(tuple(ctx.moduli))[2]
    m = len(payloads)
    raw = b"".join(payloads)
    if len(raw) != m * _row_bytes(nbits, ctx.degree):
        raise ValueError(f"rq_unpack: {len(raw)} bytes are not {m} rows of "
                         f"the context's")
    host = np.zeros((len(raw) + 7) // 8 + 1, np.int64)
    host.view(np.uint8)[:len(raw)] = np.frombuffer(raw, np.uint8)
    packed = torch.from_numpy(host).to(ctx.device)
    out = rq_unpack_cuda(ctx, packed, m)
    if packed[-1].item():
        raise SerializationError("Coefficient out of range")
    return out


def rq_pack_cuda(ctx, x: torch.Tensor) -> torch.Tensor:
    """Launch rq_pack on the (m, k, N) words x of ctx on the card (int64,
    or int32 on a narrow context). Returns a new int64 tensor on the card:
    the m packed rows in whole little-endian 8-byte words (the last one's
    bytes past the rows 0), then the kernel's flag, 1 where a word is
    wider than its modulus's nbits, else 0."""
    x = x.contiguous()
    kernels.require_cuda("rq_pack", torch.int32 if ctx.narrow
                         else torch.int64, x)
    m, k, n = x.shape
    if k != ctx.k or n != ctx.degree:
        raise ValueError(f"rq_pack: rows {tuple(x.shape)} are not of the "
                         f"context's {ctx.k} limbs of {ctx.degree}")
    c_nbits, _, nbits = _limbs(tuple(ctx.moduli))
    out = torch.empty((m * _row_bytes(nbits, n) + 7) // 8 + 1,
                      dtype=torch.int64, device=x.device)
    kernels.launch("rq_pack", "tpufhe_rq_pack", _PACK_ARGS, x.element_size(),
                   m, k, n, c_nbits, x.data_ptr(), out.data_ptr(),
                   out[-1:].data_ptr())
    return out


def rq_unpack_cuda(ctx, packed: torch.Tensor, m: int) -> torch.Tensor:
    """Launch rq_unpack on m rows of ctx packed in the int64 words
    `packed` on the card, as rq_pack_cuda lays them out; the kernel sets
    packed's last word to 1 where a residue is not below its modulus,
    else 0. Returns the new (m, k, N) words (int32 on a narrow context)."""
    kernels.require_cuda("rq_unpack", torch.int64, packed)
    c_nbits, c_moduli, nbits = _limbs(tuple(ctx.moduli))
    n = ctx.degree
    if packed.numel() != (m * _row_bytes(nbits, n) + 7) // 8 + 1:
        raise ValueError(f"rq_unpack: {packed.numel()} words do not hold "
                         f"{m} rows of the context's and the flag")
    out = torch.empty((m, ctx.k, n), device=packed.device,
                      dtype=torch.int32 if ctx.narrow else torch.int64)
    kernels.launch("rq_unpack", "tpufhe_rq_unpack", _UNPACK_ARGS,
                   out.element_size(), m, ctx.k, n, c_nbits, c_moduli,
                   packed.data_ptr(), out.data_ptr(), packed[-1:].data_ptr())
    return out
