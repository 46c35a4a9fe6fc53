"""Serialized bitstream: a real compressed file format for limg content.

The reference is a research harness with NO bitstream at all -- its
"Compression Average" is an estimate (src/limg.cpp:1629-1636), and a dead
append-blob prototype at src/limg_internal.h:96-144 shows a format was
planned but never built. This module completes that capability.

Format "LTP1" v5 (little-endian). Everything is expressed at level-0 (8x8)
block granularity: a merged level-L region or a coalesced run/rectangle is a
SEGMENT of level-0 member blocks sharing one header, which matches the fused
Morton encoder's native layout (pallas_kernels/encode_merged.py) so the
serializer consumes the state of the encode that actually ran -- no
re-encode, no layout permutation.

  magic    4s   b"LTP1"
  version  u8   5
  flags    u8   bit0 = has_alpha; bit1 = entropy coding was considered
  width    u32
  height   u32
  levels   u8   quadtree levels (1 = fixed grid)
  efactor  u16  error_factor (decoder doesn't need it; kept for tooling)
  owner    ceil(NB0/4) bytes: 2-bit owner level per 8x8 block, row-major.
           Blocks owned at level L>0 belong to the aligned 2^L-square whose
           top-left block is their segment leader.
  n_runs   u32, then n_runs x { leader u32, rect_w u16, rect_h u16 }:
           the coalesced level-0 run/rectangle segments (regions.build_runs
           geometry -- every accepted run is an axis-aligned rectangle of
           owner-level-0 blocks; leader = top-left = smallest flat index).
  n_seg    u32  total segment count (validation)
  headers  n_seg records of (2 + 6*ch*12/8) bytes, one per segment in
           (owner level, leader flat index) ascending order:
             shifts   u16: sA | sB<<4 | sC<<8  (0..8 each)
             endpoints 6*ch x 12-bit signed (value+2048), bit-packed
                       LSB-first: dirA_min/max, dirB_off/mag, dirC_off/mag
  per axis k in 0..2 (factor symbols of every segment with shift_k < 8):
    mode   u8   1 = per-segment delta transform + order-0 rANS, symbols in
                segment order (members ascending, pixels row-major);
                0 = raw fixed-width packing GROUPED BY WIDTH: for each
                width v in 1..8 ascending, the values of all blocks whose
                axis width is v (in segment order), _pack_bits(v) each
                group byte-aligned. Chosen per axis by size; the reader
                knows every width from the headers.
    mode 1: n_syms u32, n_bytes u32, n_freq u16, n_freq x u16 quantized
            frequencies (sum 4096), rANS stream (native/limg_rt_rans_*)
    mode 0: n_bytes u32, packed width groups

Deltas are along each segment's pixel stream modulo 2^(8-s): smooth content
concentrates them near 0 for the order-0 rANS. Decoding reverses the packing
and runs the standard integer reconstruction once at level-0 granularity
(ops/decode.py) with each segment's endpoints/shifts broadcast to its member
blocks -- bit-identical to the in-memory encode's decode, so
encode -> serialize -> parse -> decode is exact. Real file bits-per-pixel can
be compared against the reference's estimate (src/limg.cpp:1629-1636).

The port's copy of ``limg_tpu/bitstream.py``: the same LTP1 v5 bytes from
the same state. ``serialize_from_state`` takes the state of either
package's encode (``return_state=True``): NumPy arrays, or torch tensors,
which it moves to the host once. ``serialize`` runs the port's
``encode_image_merged`` on ``device``; ``deserialize`` runs on the host.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import native
from .config import BLOCK_SIZE, EncodeConfig
from .ops.layout import grid_for

_MAGIC = b"LTP1"
_VERSION = 5
_EP_BITS = 12          # signed endpoint field width (value + 2048)
_EP_BIAS = 2048
_HDR_FMT = "<4sBBIIBH"


def _host(x) -> np.ndarray:
    """A state array on the host: a torch tensor is copied once."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def region_header_bits(channels: int) -> int:
    """Real serialized per-region header cost (shift word + endpoints).

    v5 header records are byte-aligned at exactly this size
    (6*ch*12 is divisible by 8 for ch in {3, 4})."""
    return 16 + 6 * channels * _EP_BITS


def _pack_bits(values: np.ndarray, width: int) -> np.ndarray:
    """values (N,) uints -> bit-packed bytes, LSB-first within each value.

    Stays in uint8 when the width allows: the uint32 intermediates cost 4x
    the memory traffic on multi-megapixel factor planes."""
    if width == 0 or values.size == 0:
        return np.zeros(0, np.uint8)
    dt = np.uint8 if width <= 8 else np.uint32
    bits = (values.astype(dt)[:, None] >> np.arange(width, dtype=dt)) & dt(1)
    return np.packbits(bits.astype(np.uint8).ravel(), bitorder="little")


def _unpack_bits(data: np.ndarray, count: int, width: int) -> np.ndarray:
    """Inverse of _pack_bits: first `count` values of `width` bits each."""
    if width == 0 or count == 0:
        return np.zeros(count, np.uint32)
    bits = np.unpackbits(data, count=count * width, bitorder="little")
    vals = (bits.reshape(count, width).astype(np.uint32) << np.arange(width)).sum(axis=1)
    return vals.astype(np.uint32)


def _decode_blocks_np(q, shifts, eps, ch: int):
    """Pure-NumPy batched integer decode (ops/decode.py semantics).

    ``q``: (3, NB, P) int32 crushed factors (block-major: contiguous for the
    host layout); ``shifts``: (3, NB); ``eps``: (6ch, NB). Runs on the
    host, where the planes already are: ~20 integer vector ops."""
    _mult = np.array([1, 2, 4, 8, 17, 36, 85, 255, 0], np.int32)
    s_eff = np.minimum(shifts, 8)
    e = [eps[j * ch:(j + 1) * ch] for j in range(6)]
    normals = np.stack([e[1] - e[0], e[3] - e[2], e[5] - e[4]])  # (3, ch, NB)
    mins = np.stack([e[0], e[2], e[4]])
    dropped = (shifts > 7)[:, None, :]
    normals = np.where(dropped, 0, normals)
    mins[1:] = np.where(dropped[1:], 0, mins[1:])
    out = np.zeros((ch, *q.shape[1:]), np.int32)                 # (ch, NB, P)
    for k in range(3):
        f_dec = q[k] * _mult[s_eff[k]][:, None]                  # (NB, P)
        for c in range(ch):
            out[c] += mins[k, c][:, None] + (
                (f_dec * normals[k, c][:, None] + 128) >> 8
            )
    return np.clip(out, 0, 255).astype(np.uint8)                 # (ch, NB, P)


def _block_mask(h: int, w: int) -> np.ndarray:
    """(NB0, 64) bool pixel-validity per 8x8 block (blockify pixel order)."""
    by, bx = -(-h // BLOCK_SIZE), -(-w // BLOCK_SIZE)
    vy = (np.arange(by * 8) < h).reshape(by, 8)
    vx = (np.arange(bx * 8) < w).reshape(bx, 8)
    m = vy[:, None, :, None] & vx[None, :, None, :]      # (by, bx, 8, 8)
    return m.reshape(by * bx, 64)


def _lead_levels(owner0: np.ndarray, by: int, bx: int, num_levels: int) -> np.ndarray:
    """Per-block segment leader from the owner map (runs not yet applied):
    self for level 0, the aligned square's top-left block for level L."""
    yy, xx = np.mgrid[0:by, 0:bx]
    lead = (yy * bx + xx).reshape(-1).astype(np.int64)
    for lvl in range(1, num_levels):
        sel = owner0 == lvl
        lead_l = ((((yy >> lvl) << lvl) * bx)
                  + ((xx >> lvl) << lvl)).reshape(-1)
        lead[sel] = lead_l[sel]
    return lead


def _delta_seg(vals, seg, widths):
    """Per-segment delta transform modulo 2^width (first value kept raw;
    it is < 2^width already). int16 arithmetic: the int64 version's
    temporaries dominated a 4K serialize."""
    d = vals.astype(np.int16)
    prev = np.empty_like(d)
    prev[0] = 0
    prev[1:] = d[:-1]
    start = np.empty(d.size, bool)
    start[0] = True
    start[1:] = seg[1:] != seg[:-1]
    mask = (np.int16(1) << widths.astype(np.int16)) - np.int16(1)
    return (np.where(start, d, d - prev) & mask).astype(np.uint8)


def _undelta_seg(syms, seg, widths):
    """Inverse of _delta_seg, vectorized over the whole stream: within a
    segment, value[i] = (C[i] - C[start-1]) mod 2^w (mod commutes with the
    subtraction)."""
    c = np.cumsum(syms.astype(np.int64))
    start = np.flatnonzero(np.r_[True, seg[1:] != seg[:-1]])
    lens = np.diff(np.r_[start, syms.size])
    seg_base = np.repeat(c[start] - syms[start].astype(np.int64), lens)
    return ((c - seg_base) & ((np.int64(1) << widths) - 1)).astype(np.uint8)


def _segments_of(owner0, lead, nb):
    """Canonical segment enumeration: unique (level, leader) ascending.

    Returns (keys (nseg,), inv (NB,) segment rank per block,
    order (NB,) member columns sorted by (rank, flat index))."""
    key = owner0.astype(np.int64) * nb + lead
    uk, inv = np.unique(key, return_inverse=True)
    order = np.lexsort((np.arange(nb), key))
    return uk, inv, order


def serialize_from_state(state, cfg: EncodeConfig, entropy: bool = True) -> bytes:
    """Pack the serializer state of an already-run merged encode
    (regions.encode_image_merged(..., return_state=True)) into an LTP1 v5
    blob. Host-side only -- no re-encode, no device work beyond fetching the
    state arrays.

    ``state["q"]`` is the (3, 64, NB) uint8 axis planes of the fused paths
    or the (64, NB) packed int32 words of the JAX package's dense path."""
    rows = _host(state["rows"])
    h, w = state["height"], state["width"]
    num_levels, ch = state["num_levels"], state["channels"]
    by, bx = -(-h // BLOCK_SIZE), -(-w // BLOCK_SIZE)
    nb = by * bx
    owner0 = rows[0].astype(np.int64)
    s_blk = np.minimum(rows[1:4], 8).astype(np.int64)            # (3, NB)
    eps_blk = rows[4:4 + 6 * ch].astype(np.int64)                # (6ch, NB)
    run_seg = rows[4 + 6 * ch].astype(np.int64)
    run_applied = rows[5 + 6 * ch].astype(bool)

    # -- coalesced runs -> explicit rectangles ------------------------------
    midx = np.nonzero(run_applied)[0]
    if midx.size:
        o = np.argsort(run_seg[midx], kind="stable")
        ml, mi = run_seg[midx][o], midx[o]
        starts = np.flatnonzero(np.r_[True, ml[1:] != ml[:-1]])
        run_lead = ml[starts]
        ys, xs = mi // bx, mi % bx
        y0 = np.minimum.reduceat(ys, starts)
        y1 = np.maximum.reduceat(ys, starts)
        x0 = np.minimum.reduceat(xs, starts)
        x1 = np.maximum.reduceat(xs, starts)
        rw, rh = x1 - x0 + 1, y1 - y0 + 1
        counts = np.diff(np.r_[starts, mi.size])
        if (not np.array_equal(run_lead, y0 * bx + x0)
                or not np.array_equal(rw * rh, counts)):
            raise RuntimeError("coalesced run is not a leader-anchored rectangle")
    else:
        run_lead = np.zeros(0, np.int64)
        rw = rh = np.zeros(0, np.int64)

    lead = _lead_levels(owner0, by, bx, num_levels)
    lead[midx] = run_seg[midx]
    keys, inv, order = _segments_of(owner0, lead, nb)
    nseg = keys.size
    leaders = (keys % nb).astype(np.int64)

    # -- header records (contiguous fixed-size, bulk-built) -----------------
    s_hdr = s_blk[:, leaders]                                    # (3, nseg)
    ep_hdr = eps_blk[:, leaders].T                               # (nseg, 6ch)
    if native.factor_kernels_available():
        recs = native.pack_headers(s_hdr, ep_hdr, ch)
    else:
        swords = (s_hdr[0] | (s_hdr[1] << 4) | (s_hdr[2] << 8)).astype("<u2")
        bits = ((ep_hdr + _EP_BIAS).astype(np.uint32)[:, :, None]
                >> np.arange(_EP_BITS)) & 1
        ep_bytes_arr = np.packbits(
            bits.astype(np.uint8).reshape(nseg, -1), axis=1, bitorder="little"
        )
        recs = np.concatenate(
            [swords.view(np.uint8).reshape(nseg, 2), ep_bytes_arr], axis=1
        )

    out = bytearray()
    flags = int(cfg.has_alpha) | (int(entropy) << 1)
    out += struct.pack(_HDR_FMT, _MAGIC, _VERSION, flags, w, h,
                       num_levels, cfg.error_factor & 0xFFFF)
    out += _pack_bits(owner0.astype(np.uint32), 2).tobytes()
    out += struct.pack("<I", run_lead.size)
    run_rec = np.zeros(run_lead.size, dtype=[("l", "<u4"), ("w", "<u2"), ("h", "<u2")])
    run_rec["l"], run_rec["w"], run_rec["h"] = run_lead, rw, rh
    out += run_rec.tobytes()
    out += struct.pack("<I", nseg)
    out += recs.tobytes()

    # -- per-axis factor symbol sections ------------------------------------
    maskb = _block_mask(h, w)                                    # (NB, 64)
    pixcnt = maskb.sum(axis=1)
    seg_cols = inv[order]
    q_packed = _host(state["q"])
    use_native = native.factor_kernels_available()
    if q_packed.ndim == 3:
        # (3, P, NB) u8 axis planes (fused-path state; smaller fetch)
        if use_native:
            q3 = np.ascontiguousarray(q_packed.transpose(0, 2, 1))
        else:
            q_packed = (q_packed[0].astype(np.int32)
                        | (q_packed[1].astype(np.int32) << 8)
                        | (q_packed[2].astype(np.int32) << 16))
    elif use_native:
        # single-pass C++ extract from the (P, NB) packed-i32 row
        # (runtime/limg_runtime.cpp); byte-identical to the NumPy path below
        q3 = native.factor_extract(q_packed)                     # (3, NB, 64)
    if use_native:
        maskb_u8 = np.ascontiguousarray(maskb, np.uint8)
    for k in range(3):
        wk = (8 - s_hdr[k]).astype(np.int16)                     # (nseg,)
        w_blk = wk[seg_cols]                  # width per ordered member col
        selc = w_blk > 0
        ck = order[selc]
        wb = w_blk[selc]
        cnts = pixcnt[ck]
        nv = np.bincount(wb, weights=cnts, minlength=9).astype(np.int64)
        raw_bytes = int(sum(-(-nv[v] * v // 8) for v in range(1, 9)))
        use_rans = False
        if use_native:
            n_pix = int(cnts.sum())
            vals, syms, hist, raw_blob, _ = native.factor_pack_axis(
                q3[k], maskb_u8, ck, seg_cols[selc], wb, n_pix)
            if entropy and n_pix:
                freqs = native.rans_quantize_freqs(hist)
                stream = native.rans_encode(syms, freqs)
                n_freq = int(np.max(np.nonzero(freqs)[0])) + 1
                use_rans = 8 + 2 + 2 * n_freq + len(stream) < 4 + raw_bytes
            if use_rans:
                out += struct.pack("<BIIH", 1, syms.size, len(stream), n_freq)
                out += freqs[:n_freq].astype(np.uint16).tobytes()
                out += stream
            else:
                out += struct.pack("<BI", 0, raw_bytes)
                out += raw_blob.tobytes()
            continue
        qk = ((q_packed >> (8 * k)) & 0xFF).astype(np.uint8).T   # (NB, 64)
        mm = maskb[ck]                                           # (n, 64)
        vals = qk[ck][mm]
        # per-VALUE width/segment via broadcast + the same boolean mask
        # (cheaper than np.repeat over per-element counts)
        n_sel = ck.size
        wv = np.broadcast_to(wb[:, None], (n_sel, 64))[mm]
        if entropy and vals.size:
            sk32 = seg_cols[selc].astype(np.int32)
            sv = np.broadcast_to(sk32[:, None], (n_sel, 64))[mm]
            syms = _delta_seg(vals, sv, wv)
            freqs = native.rans_quantize_freqs(np.bincount(syms, minlength=256))
            stream = native.rans_encode(syms, freqs)
            n_freq = int(np.max(np.nonzero(freqs)[0])) + 1
            use_rans = 8 + 2 + 2 * n_freq + len(stream) < 4 + raw_bytes
        if use_rans:
            out += struct.pack("<BIIH", 1, syms.size, len(stream), n_freq)
            out += freqs[:n_freq].astype(np.uint16).tobytes()
            out += stream
        else:
            out += struct.pack("<BI", 0, raw_bytes)
            for v in range(1, 9):
                if nv[v]:
                    out += _pack_bits(vals[wv == v], v).tobytes()
    return bytes(out)


def serialize(image, cfg: EncodeConfig, seed: int = 0, num_levels: int = 3,
              merge_policy: str = "match", rd_lambda: float = 0.01, entropy: bool = True,
              coalesce: bool = True, fused: bool | None = None, device="cuda") -> bytes:
    """Encode an (H, W, 3|4) uint8 image into an LTP1 blob.

    Runs the port's merged encode on ``device`` (``fused`` picks its path
    as in ``regions.encode_image_merged``: ``num_levels=1``, the fixed grid,
    and ``fused=False`` take the dense path, and so do 5 levels or more) and
    packs its state; the stream always represents exactly the encode that
    ran. The RD policy optimizes the real serialized header cost.
    ``entropy=False`` skips the rANS mode entirely. At 5 levels or more the
    stream is written as the JAX package writes it, and ``deserialize``
    refuses it, as the JAX package's does (its header check takes 1-4
    levels)."""
    from .regions import encode_image_merged

    _, state = encode_image_merged(
        image, cfg, seed=seed, num_levels=num_levels, fetch_planes=False,
        fetch_decoded=False, merge_policy=merge_policy, rd_lambda=rd_lambda,
        coalesce=coalesce, return_state=True,
        rd_header_bits=region_header_bits(cfg.channels)
        if merge_policy == "rd" else None, fused=fused, device=device,
    )
    return serialize_from_state(state, cfg, entropy=entropy)


def deserialize(blob: bytes):
    """Parse an LTP1 v5 blob and reconstruct the image.

    Returns ((H, W, 4) uint8 decoded image, info dict). Raises ValueError on
    malformed or truncated streams."""
    try:
        magic, ver, flags, w, h, num_levels, ef = struct.unpack_from(_HDR_FMT, blob, 0)
    except struct.error as e:
        raise ValueError(f"not an LTP1 stream: {e}")
    if magic != _MAGIC or ver != _VERSION:
        raise ValueError("not an LTP1 v5 stream")
    if not (1 <= num_levels <= 4) or h == 0 or w == 0:
        raise ValueError("corrupt LTP1 stream: bad dimensions/levels")
    has_alpha = bool(flags & 1)
    ch = 4 if has_alpha else 3
    off = struct.calcsize(_HDR_FMT)
    by, bx = -(-h // BLOCK_SIZE), -(-w // BLOCK_SIZE)
    nb = by * bx

    owner_bytes = -(-nb * 2 // 8)
    owner0 = _unpack_bits(
        np.frombuffer(blob, np.uint8, owner_bytes, off), nb, 2
    ).astype(np.int64)
    off += owner_bytes
    if (owner0 >= num_levels).any():
        raise ValueError("corrupt LTP1 stream: owner level out of range")

    (n_runs,) = struct.unpack_from("<I", blob, off)
    off += 4
    run_rec = np.frombuffer(
        blob, dtype=[("l", "<u4"), ("w", "<u2"), ("h", "<u2")],
        count=n_runs, offset=off,
    )
    off += 8 * n_runs
    lead = _lead_levels(owner0, by, bx, num_levels)
    if n_runs:
        rl = run_rec["l"].astype(np.int64)
        rw = run_rec["w"].astype(np.int64)
        rh = run_rec["h"].astype(np.int64)
        if ((rw < 1) | (rh < 1) | (rl % bx + rw > bx)
                | (rl // bx + rh > by)).any():
            raise ValueError("corrupt LTP1 stream: run rectangle out of bounds")
        sizes = rw * rh
        rep_l = np.repeat(rl, sizes)
        gidx = np.arange(int(sizes.sum())) - np.repeat(np.cumsum(sizes) - sizes, sizes)
        rep_w = np.repeat(rw, sizes)
        mem = rep_l + (gidx // rep_w) * bx + gidx % rep_w
        # runs may coalesce regions of ANY owner level (level-L runs cover
        # whole 2^L squares); all members must share the leader's level
        if np.unique(mem).size != mem.size or (owner0[mem] != owner0[rep_l]).any():
            raise ValueError("corrupt LTP1 stream: overlapping or mixed-level runs")
        lead[mem] = rep_l

    keys, inv, order = _segments_of(owner0, lead, nb)
    nseg = keys.size
    (n_seg_stored,) = struct.unpack_from("<I", blob, off)
    off += 4
    if n_seg_stored != nseg:
        raise ValueError("corrupt LTP1 stream: segment count mismatch")

    rec = 2 + 6 * ch * _EP_BITS // 8
    raw = np.frombuffer(blob, np.uint8, rec * nseg, off).reshape(nseg, rec)
    off += rec * nseg
    if native.factor_kernels_available():
        s_hdr, ep_hdr = native.unpack_headers(raw, ch)
        s_hdr = s_hdr.astype(np.int64)
        ep_hdr = ep_hdr.astype(np.int64)
    else:
        swords = raw[:, 0].astype(np.int64) | (raw[:, 1].astype(np.int64) << 8)
        s_hdr = np.stack(
            [swords & 0xF, (swords >> 4) & 0xF, (swords >> 8) & 0xF])
        bits = np.unpackbits(raw[:, 2:], axis=1, bitorder="little")
        bits = bits[:, : 6 * ch * _EP_BITS].reshape(nseg, 6 * ch, _EP_BITS)
        ep_hdr = ((bits.astype(np.int64) << np.arange(_EP_BITS)).sum(axis=2)
                  - _EP_BIAS)                                    # (nseg, 6ch)
    if (s_hdr > 8).any():
        raise ValueError("corrupt LTP1 stream: shift out of range")

    maskb = _block_mask(h, w)
    pixcnt = maskb.sum(axis=1)
    seg_cols = inv[order]
    use_native = native.factor_kernels_available()
    if use_native:
        # single-pass C++ undelta/unpack + scatter per axis, then native
        # integer decode + unblockify (runtime/limg_runtime.cpp) -- the
        # NumPy path below is the bit-identical fallback
        q3 = np.zeros((3, nb, 64), np.uint8)
        maskb_u8 = np.ascontiguousarray(maskb, np.uint8)
    else:
        q = np.zeros((3, nb * 64), np.int32)
    for k in range(3):
        wk = (8 - s_hdr[k]).astype(np.int16)
        w_blk = wk[seg_cols]
        selc = w_blk > 0
        ck = order[selc]
        wb = w_blk[selc]
        cnts = pixcnt[ck]
        n_k = int(cnts.sum())
        n_sel = ck.size
        if not use_native:
            mm = maskb[ck]
            tgt = (ck[:, None] * 64 + np.arange(64))[mm]
            wv = np.broadcast_to(wb[:, None], (n_sel, 64))[mm]
        (mode,) = struct.unpack_from("<B", blob, off)
        off += 1
        if mode == 1:
            n_syms, n_bytes, n_freq = struct.unpack_from("<IIH", blob, off)
            off += 10
            if n_syms != n_k:
                raise ValueError("corrupt LTP1 stream: symbol count mismatch")
            freqs = np.zeros(256, np.uint32)
            freqs[:n_freq] = np.frombuffer(blob, np.uint16, n_freq, off)
            off += 2 * n_freq
            syms = (native.rans_decode(blob[off:off + n_bytes], freqs, n_syms)
                    if n_syms else np.zeros(0, np.uint8))
            off += n_bytes
            if use_native:
                native.factor_unpack_axis_syms(
                    syms, maskb_u8, ck, seg_cols[selc], wb, q3[k])
            else:
                sk32 = seg_cols[selc].astype(np.int32)
                sv = np.broadcast_to(sk32[:, None], (n_sel, 64))[mm]
                vals = _undelta_seg(syms, sv, wv) if n_syms else syms
                q[k, tgt] = vals
        elif mode == 0:
            (n_bytes,) = struct.unpack_from("<I", blob, off)
            off += 4
            nv = np.bincount(wb, weights=cnts, minlength=9).astype(np.int64)
            if n_bytes != int(sum(-(-nv[v] * v // 8) for v in range(1, 9))):
                raise ValueError("corrupt LTP1 stream: raw section length mismatch")
            if use_native:
                gb = np.array([0] + [-(-int(nv[v]) * v // 8)
                                     for v in range(1, 9)], np.int64)
                native.factor_unpack_axis_raw(
                    np.frombuffer(blob, np.uint8, n_bytes, off), gb,
                    maskb_u8, ck, wb, q3[k])
                off += n_bytes
            else:
                pos = off
                for v in range(1, 9):
                    if not nv[v]:
                        continue
                    n_v = int(nv[v])
                    gbytes = -(-n_v * v // 8)
                    vals_v = _unpack_bits(
                        np.frombuffer(blob, np.uint8, gbytes, pos), n_v, v
                    )
                    pos += gbytes
                    q[k, tgt[wv == v]] = vals_v
                off = pos
        else:
            raise ValueError("corrupt LTP1 stream: unknown section mode")
    if off != len(blob):
        raise ValueError("corrupt LTP1 stream: trailing bytes")

    # one level-0 decode with each segment's header broadcast to its blocks,
    # entirely on host (see _decode_blocks_np / limg_rt_decode_blocks)
    shifts_blk = s_hdr[:, inv].astype(np.int32)                  # (3, NB)
    eps_blk = ep_hdr[inv].T.astype(np.int32)                     # (6ch, NB)
    if use_native:
        words = native.decode_blocks_native(q3, shifts_blk, eps_blk, ch)
        decoded = native.unblockify_packed(words, h, w)          # (H, W, 4)
        if ch == 3:
            decoded[..., 3] = 0xFF
        info = dict(
            width=w, height=h, has_alpha=has_alpha, levels=num_levels,
            error_factor=ef, stream_bytes=len(blob),
            real_bpp=len(blob) * 8.0 / (w * h),
            n_runs=int(n_runs), n_segments=int(nseg),
        )
        return np.ascontiguousarray(decoded), info
    dec = _decode_blocks_np(
        q.reshape(3, nb, 64), shifts_blk, eps_blk, ch
    )                                                            # (ch, NB, 64)
    grid0 = grid_for(h, w, BLOCK_SIZE)
    by_g, bx_g = grid0.blocks_y, grid0.blocks_x
    tiles = dec.reshape(ch, by_g, bx_g, 8, 8).transpose(1, 3, 2, 4, 0)
    decoded = tiles.reshape(by_g * 8, bx_g * 8, ch)[:h, :w]
    if ch == 3:
        decoded = np.concatenate(
            [decoded, np.full((h, w, 1), 0xFF, np.uint8)], axis=-1
        )
    info = dict(
        width=w, height=h, has_alpha=has_alpha, levels=num_levels,
        error_factor=ef, stream_bytes=len(blob),
        real_bpp=len(blob) * 8.0 / (w * h),
        n_runs=int(n_runs), n_segments=int(nseg),
    )
    return np.ascontiguousarray(decoded), info
