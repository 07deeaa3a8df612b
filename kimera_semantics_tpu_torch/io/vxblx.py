"""voxblox `.vxblx` wire-format compatibility for the TSDF layer.

Counterpart: kimera_semantics_tpu/io/vxblx.py. The reference checkpoints
maps with `vxb::io::SaveLayer`: a protobuf stream file of a varint message
count, a varint-delimited `LayerProto` header and one varint-delimited
`BlockProto` per allocated block. Voxel payloads are flat `repeated uint32
voxel_data` words in x-fastest linear voxel order:

  TSDF voxel  -> 3 words: f32 bits of distance, f32 bits of weight,
                 packed color (r<<24 | g<<16 | b<<8 | a)

A multi-layer file is a concatenation of sections. No protobuf runtime is
used: the proto2 wire format is hand-encoded with vectorized numpy. The
writer emits unpacked `repeated uint32` (as voxblox does); the reader also
accepts the packed encoding. Storage tiles finer than the user's block
side (GridConfig.io_voxels_per_side) regroup into whole blocks on save and
split on load. The ESDF layer is not ported yet (slice D): saving one
raises, and loading reads the TSDF section only.
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np
import torch

from ..config import FusionConfig
from ..grid import blocks as gblocks
from ..grid.blocks import VoxelGrid

LAYER_TYPE_TSDF = "tsdf"
TSDF_WORDS_PER_VOXEL = 3

_TAG_VOXEL_DATA = (7 << 3) | 0   # field 7, varint
_TAG_VOXEL_DATA_PACKED = (7 << 3) | 2  # field 7, length-delimited


# ---------------------------------------------------------------------------
# proto2 wire-format primitives (scalar + vectorized)
# ---------------------------------------------------------------------------

def _enc_varint(v: int) -> bytes:
    out = bytearray()
    v = int(v)
    while True:
        b = v & 0x7F
        v >>= 7
        if v:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _dec_varint(data, off: int):
    val, shift = 0, 0
    while True:
        b = data[off]
        off += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, off
        shift += 7


def _enc_tagged_varints(tag: int, vals: np.ndarray) -> bytes:
    """Vectorized encode of an unpacked repeated-varint field: for every value,
    one tag byte followed by its varint (uint32 -> at most 5 bytes)."""
    v = np.ascontiguousarray(vals, dtype=np.uint64).reshape(-1)
    n = v.size
    cols = np.empty((n, 6), np.uint8)
    cols[:, 0] = tag
    for i in range(5):
        cols[:, i + 1] = ((v >> np.uint64(7 * i)) & np.uint64(0x7F)).astype(
            np.uint8)
    nb = np.ones(n, np.int64)
    for i in range(1, 5):
        nb[v >= (1 << (7 * i))] = i + 1
    j = np.arange(6)[None, :]
    cont = (j >= 1) & (j < nb[:, None])          # non-final varint bytes
    keep = j <= nb[:, None]                       # tag byte + nb varint bytes
    cols = np.where(cont, cols | 0x80, cols)
    return cols[keep].tobytes()


def _token_bounds(buf: np.ndarray):
    """Varint token boundaries in a buffer containing only varints: a token
    ends at every byte with the continuation bit clear."""
    ends = np.flatnonzero(buf < 0x80)
    starts = np.empty_like(ends)
    starts[0] = 0
    starts[1:] = ends[:-1] + 1
    return starts, ends


def _dec_varint_array(buf: np.ndarray, starts: np.ndarray,
                      lens: np.ndarray) -> np.ndarray:
    vals = np.zeros(starts.size, np.uint64)
    for i in range(int(lens.max(initial=0))):
        m = lens > i
        vals[m] |= (buf[starts[m] + i].astype(np.uint64)
                    & np.uint64(0x7F)) << np.uint64(7 * i)
    return vals


def _dec_unpacked_run(buf: np.ndarray, tag: int) -> np.ndarray:
    """Vectorized decode of a buffer that is exactly a run of (tag, varint)
    pairs (the tail of a BlockProto once field 7 starts)."""
    if buf.size == 0:
        return np.zeros(0, np.uint64)
    if buf[-1] >= 0x80:
        raise IOError("vxblx: truncated varint in voxel_data")
    starts, ends = _token_bounds(buf)
    if starts.size % 2:
        raise IOError("vxblx: odd token count in unpacked voxel_data run")
    tag_starts, tag_ends = starts[0::2], ends[0::2]
    if not (np.all(tag_starts == tag_ends)
            and np.all(buf[tag_starts] == tag)):
        raise IOError("vxblx: unexpected field interleaved with voxel_data")
    vstarts, vends = starts[1::2], ends[1::2]
    return _dec_varint_array(buf, vstarts, vends - vstarts + 1)


def _dec_packed_run(buf: np.ndarray) -> np.ndarray:
    """Vectorized decode of a packed repeated-varint payload (bare varints)."""
    if buf.size == 0:
        return np.zeros(0, np.uint64)
    if buf[-1] >= 0x80:
        raise IOError("vxblx: truncated varint in packed voxel_data")
    starts, ends = _token_bounds(buf)
    return _dec_varint_array(buf, starts, ends - starts + 1)


# ---------------------------------------------------------------------------
# Message encode/decode
# ---------------------------------------------------------------------------

def _field_double(num: int, val: float) -> bytes:
    return bytes([(num << 3) | 1]) + struct.pack("<d", float(val))


def _field_varint(num: int, val: int) -> bytes:
    return bytes([(num << 3) | 0]) + _enc_varint(val)


def _field_bytes(num: int, payload: bytes) -> bytes:
    return bytes([(num << 3) | 2]) + _enc_varint(len(payload)) + payload


def _encode_layer_header(voxel_size: float, vps: int, ltype: str) -> bytes:
    return (_field_double(1, voxel_size) + _field_varint(2, vps)
            + _field_bytes(3, ltype.encode()))


def _encode_block(voxel_size: float, vps: int, origin: np.ndarray,
                  words: np.ndarray) -> bytes:
    head = (_field_double(1, voxel_size) + _field_varint(2, vps)
            + _field_double(3, origin[0]) + _field_double(4, origin[1])
            + _field_double(5, origin[2]) + _field_varint(6, 1))
    return head + _enc_tagged_varints(_TAG_VOXEL_DATA, words)


def _parse_message(data: bytes) -> dict:
    """Parse one LayerProto/BlockProto. Scalar fields are walked in Python;
    the first voxel_data element hands the rest of the message to the
    vectorized run decoder (serializers emit fields in field-number order,
    so field 7 is always the message tail)."""
    fields: dict = {}
    off, end = 0, len(data)
    buf = np.frombuffer(data, np.uint8)
    while off < end:
        key, off = _dec_varint(data, off)
        num, wt = key >> 3, key & 7
        if num == 7 and wt == 0:
            fields[7] = _dec_unpacked_run(buf[off - 1:], _TAG_VOXEL_DATA)
            break
        if num == 7 and wt == 2:
            ln, off = _dec_varint(data, off)
            vals = _dec_packed_run(buf[off:off + ln])
            fields[7] = (np.concatenate([fields[7], vals])
                         if 7 in fields else vals)
            off += ln
        elif wt == 0:
            fields[num], off = _dec_varint(data, off)
        elif wt == 1:
            fields[num] = struct.unpack_from("<d", data, off)[0]
            off += 8
        elif wt == 2:
            ln, off = _dec_varint(data, off)
            fields[num] = data[off:off + ln]
            off += ln
        elif wt == 5:
            fields[num] = struct.unpack_from("<f", data, off)[0]
            off += 4
        else:
            raise IOError(f"vxblx: unsupported wire type {wt}")
    return fields


# ---------------------------------------------------------------------------
# File-level sections
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class LayerSection:
    """One SaveLayer section: header + per-block origins/payload words."""

    type: str
    voxel_size: float
    voxels_per_side: int
    block_origins: np.ndarray  # (N, 3) float64 world-space block origins
    voxel_data: np.ndarray     # (N, vps^3 * words_per_voxel) uint32


def write_sections(path: str, sections, append: bool = False) -> None:
    with open(path, "ab" if append else "wb") as f:
        for sec in sections:
            f.write(_enc_varint(1 + len(sec.block_origins)))
            hdr = _encode_layer_header(sec.voxel_size, sec.voxels_per_side,
                                       sec.type)
            f.write(_enc_varint(len(hdr)))
            f.write(hdr)
            for origin, words in zip(sec.block_origins, sec.voxel_data):
                msg = _encode_block(sec.voxel_size, sec.voxels_per_side,
                                    origin, words)
                f.write(_enc_varint(len(msg)))
                f.write(msg)


def read_sections(path: str):
    with open(path, "rb") as f:
        data = f.read()
    out, off = [], 0
    while off < len(data):
        count, off = _dec_varint(data, off)
        if count < 1:
            raise IOError(f"{path}: empty vxblx section")
        ln, off = _dec_varint(data, off)
        hdr = _parse_message(data[off:off + ln])
        off += ln
        vps = int(hdr.get(2, 0))
        ltype = hdr.get(3, b"").decode()
        origins, payloads = [], []
        for _ in range(count - 1):
            ln, off = _dec_varint(data, off)
            blk = _parse_message(data[off:off + ln])
            off += ln
            origins.append([blk.get(3, 0.0), blk.get(4, 0.0),
                            blk.get(5, 0.0)])
            payloads.append(blk.get(7, np.zeros(0, np.uint64))
                            .astype(np.uint32))
        out.append(LayerSection(
            type=ltype, voxel_size=float(hdr.get(1, 0.0)),
            voxels_per_side=vps,
            block_origins=np.asarray(origins, np.float64).reshape(-1, 3),
            voxel_data=(np.stack(payloads) if payloads
                        else np.zeros((0, 0), np.uint32))))
    return out


# ---------------------------------------------------------------------------
# Voxel-order permutation: ours is z-fastest ((x*vps + y)*vps + z,
# grid/blocks.py voxel_to_block_local); voxblox linear order is x-fastest
# (x + vps*(y + vps*z), Block::computeLinearIndexFromVoxelIndex). The
# permutation (swap x/z axes) is an involution, so it converts both ways.
# ---------------------------------------------------------------------------

def _voxel_perm(vps: int) -> np.ndarray:
    return (np.arange(vps ** 3).reshape(vps, vps, vps)
            .transpose(2, 1, 0).reshape(-1))


# ---------------------------------------------------------------------------
# Storage-tile <-> IO-block regrouping (GridConfig.io_voxels_per_side).
#
# The grid's storage tiling is an internal layout choice (16^3 tiles pack the
# TPU's (8, 128) tile groups and sample finer mips); the serialized block
# side is the *user's* layer config. Voxel state is identical under any
# storage tiling — updates are per voxel, and allocating finer blocks is a
# strict sparsity refinement — so a vps=32 layer maps to 2x2x2 sibling 16^3
# tiles. At this boundary the r^3 siblings regroup into one io_vps^3 block
# (absent siblings fill with default/unobserved voxels, exactly what the
# reference stores for never-touched voxels of an allocated block).
# All payloads here are x-fastest voxblox linear order.
# ---------------------------------------------------------------------------


def _fine_to_parent_positions(vps: int, io_vps: int,
                              oc: np.ndarray) -> np.ndarray:
    """Per fine block with octant offsets oc (n, 3) in [0, r): the parent
    x-fastest linear position of each of its vps^3 voxels -> (n, vps^3)."""
    i = np.arange(vps ** 3)
    x, y, z = i % vps, (i // vps) % vps, i // (vps * vps)
    return ((oc[:, 0:1] * vps + x[None])
            + io_vps * ((oc[:, 1:2] * vps + y[None])
                        + io_vps * (oc[:, 2:3] * vps + z[None])))


def _regroup_blocks(block_idx: np.ndarray, words: np.ndarray, vps: int,
                    io_vps: int, default_words: np.ndarray):
    """(nb, 3) fine coords + (nb, vps^3, W) payloads -> unique coarse coords
    (np, 3) + (np, io_vps^3, W) payloads, default-filled where no sibling."""
    r = io_vps // vps
    parent = np.floor_divide(block_idx, r)
    oc = block_idx - parent * r
    if len(block_idx) == 0:
        return parent, np.zeros((0, io_vps ** 3, words.shape[-1]),
                                words.dtype)
    uniq, inv = np.unique(parent, axis=0, return_inverse=True)
    tgt = _fine_to_parent_positions(vps, io_vps, oc)
    out = np.broadcast_to(default_words,
                          (len(uniq), io_vps ** 3, words.shape[-1])).copy()
    out[inv[:, None], tgt] = words
    return uniq, out


def _split_blocks(parent_idx: np.ndarray, words: np.ndarray, vps: int,
                  io_vps: int):
    """Inverse of _regroup_blocks: (n, 3) coarse coords + (n, io_vps^3, W)
    -> all r^3 children as ((n*r^3, 3) fine coords, (n*r^3, vps^3, W));
    callers filter empty children (sparsity refinement)."""
    r = io_vps // vps
    n = len(parent_idx)
    ocs = np.stack(np.meshgrid(np.arange(r), np.arange(r), np.arange(r),
                               indexing="ij"), axis=-1).reshape(-1, 3)
    tgt = _fine_to_parent_positions(vps, io_vps, ocs)       # (r^3, vps^3)
    child_words = words[:, tgt, :].reshape(n * r ** 3, vps ** 3,
                                           words.shape[-1])
    child_idx = (parent_idx[:, None, :] * r
                 + ocs[None, :, :]).reshape(n * r ** 3, 3)
    return child_idx, child_words


# ---------------------------------------------------------------------------
# Grid <-> TSDF section
# ---------------------------------------------------------------------------

def grid_to_tsdf_section(grid: VoxelGrid, cfg: FusionConfig) -> LayerSection:
    g = cfg.grid
    nb = int(grid.n_blocks)
    perm = _voxel_perm(g.voxels_per_side)
    host = lambda t: t.cpu().numpy()  # noqa: E731
    dist = host(gblocks.tsdf_distance(grid, cfg.tsdf.truncation_distance)
                [:nb])[:, perm]
    wt = host(gblocks.tsdf_weight(grid, cfg.tsdf.max_weight)[:nb])[:, perm]
    col = host(gblocks.voxel_color(grid)[:, :nb])[:, :, perm]
    w0 = dist.astype(np.float32).view(np.uint32)
    w1 = wt.astype(np.float32).view(np.uint32)
    alpha = np.where(wt > 0, 255, 0).astype(np.uint32)
    w2 = ((col[0].astype(np.uint32) << 24) | (col[1].astype(np.uint32) << 16)
          | (col[2].astype(np.uint32) << 8) | alpha)
    words = np.stack([w0, w1, w2], axis=-1)                  # (nb, vps3, 3)
    block_idx = host(grid.block_coords[:nb]).astype(np.int64)
    io_vps = g.io_vps
    if io_vps != g.voxels_per_side:
        # Regroup storage tiles into the user-config block side (default
        # voxel: dist 0 / weight 0 / color 0, the reference's untouched
        # voxels of an allocated block).
        block_idx, words = _regroup_blocks(
            block_idx, words, g.voxels_per_side, io_vps,
            np.zeros((3,), np.uint32))
    words = words.reshape(len(block_idx), -1)
    origins = block_idx.astype(np.float64) * (g.voxel_size * io_vps)
    return LayerSection(LAYER_TYPE_TSDF, g.voxel_size, io_vps,
                        origins, words)


def tsdf_section_to_grid(sec: LayerSection, cfg: FusionConfig,
                         device="cuda") -> VoxelGrid:
    """kReplace merge semantics (vxb::io::LoadBlocksFromFile): the file's
    blocks replace the in-memory layer (a new grid on `device`)."""
    g = cfg.grid
    if sec.voxels_per_side != g.io_vps:
        raise ValueError(
            f"vxblx vps {sec.voxels_per_side} != config {g.io_vps}")
    if abs(sec.voxel_size - g.voxel_size) > 1e-9:
        raise ValueError(
            f"vxblx voxel_size {sec.voxel_size} != config {g.voxel_size}")
    n = len(sec.block_origins)
    io_vps = g.io_vps
    words = sec.voxel_data.reshape(n, io_vps ** 3, TSDF_WORDS_PER_VOXEL)
    block_idx = np.floor(sec.block_origins / (g.voxel_size * io_vps)
                         + 0.5).astype(np.int64)
    if io_vps != g.voxels_per_side:
        # Split user-side blocks into storage tiles; keep observed ones only
        # (weight > 0 somewhere), the sparsity refinement.
        block_idx, words = _split_blocks(block_idx, words,
                                         g.voxels_per_side, io_vps)
        keep = (np.ascontiguousarray(words[..., 1]).view(np.float32)
                > 0).any(axis=1)
        block_idx, words = block_idx[keep], words[keep]
        n = len(block_idx)
    grid = gblocks.create(cfg, device=device)
    if n == 0:
        return grid
    perm = _voxel_perm(g.voxels_per_side)
    dist = np.ascontiguousarray(words[:, perm, 0]).view(np.float32)
    wt = np.ascontiguousarray(words[:, perm, 1]).view(np.float32)
    packed = words[:, perm, 2]
    rgb = np.stack([(packed >> 24) & 0xFF, (packed >> 16) & 0xFF,
                    (packed >> 8) & 0xFF]).astype(np.float32)
    dev = grid.wsum.device
    coords = torch.as_tensor(block_idx.astype(np.int32), device=dev)
    grid = gblocks.allocate_blocks(
        grid, coords, torch.ones(n, dtype=torch.bool, device=dev), g)
    slots = gblocks.lookup_slots(grid, coords, g).long()
    t = lambda a: torch.as_tensor(a, device=dev)  # noqa: E731
    grid.wsum[slots] = t(wt)
    grid.wsdf[slots] = t(dist * wt)
    grid.wcolor[:, slots] = t(rgb * wt[None])
    grid.updated[slots] = True
    return grid


# ---------------------------------------------------------------------------
# Top-level save/load (the saveMap/loadMap interop surface)
# ---------------------------------------------------------------------------

def save_vxblx(path: str, grid: VoxelGrid, cfg: FusionConfig,
               esdf=None) -> None:
    """Write `<path>` with the TSDF layer, as the reference's saveMap
    does. The ESDF layer is not ported yet (slice D)."""
    if esdf is not None:
        raise NotImplementedError(
            "the ESDF layer of .vxblx is not ported yet (slice D)")
    write_sections(path, [grid_to_tsdf_section(grid, cfg)])


def load_vxblx(path: str, cfg: FusionConfig, device="cuda") -> VoxelGrid:
    """Load the TSDF layer from a (possibly multi-layer) .vxblx file."""
    for sec in read_sections(path):
        if sec.type == LAYER_TYPE_TSDF:
            return tsdf_section_to_grid(sec, cfg, device=device)
    raise IOError(f"{path}: no tsdf layer section found")
