"""Fused score: decode + boolean eval + similarity + sub-block maxima.

Counterpart of ``trinity_tpu/ops/fusedscore.py``. Per (window, query) the
kernels decode the query's term cells (or read the hot-term plane
``tf_planes[cid, w]`` for cached slots), evaluate the boolean structure and
the similarity per doc, and write

  - the masked score tile, (B, W, 128, 128) f32, -inf where nothing matches;
  - per-sub-block maxima, (B, W, 16, 128) f32: sub-block s of a window is
    docs [s*1024, (s+1)*1024), its max broadcast over the 128 lanes.

``exact_window_topk`` then selects the top-k exactly with the docid-asc
tie-break, by picking sub-blocks first.

Two kernels, both in ``csrc/fusedscore.cu``:

``fused_flat_score_tiles`` (replaces the reference's
``fused_flat_score_tiles``, ``fusedscore.py:421``, Pallas body
``_make_score_kernel(flat=True)``). Flat AND/OR/NOT/k-of-n/optional shapes
arrive as data (per-slot flags 1 = required, 2 = negated, 4 = optional, and
kmin). The TPU kernel held every slot's tile of a (window, query) in VMEM
at once. On the H100 the call is bound by bytes: the score tiles and
sub-block maxima written once (B * W * 72 KiB, most of the call), each
distinct hot-term plane read once (64 KiB a window) and the decoded
slots' postings blocks. A block of 256 threads owns half a window of one
query, with the query fastest in the grid, so a plane that several
queries of a window read comes from L2, not device memory. Its docs'
running state (f32 sum, required count and negated flag) is in shared
memory (40 KiB, 4 blocks an SM). A thread owns the same 32 docs in every
dense step, so cached slots follow one another with no barrier, each
thread's 8 16-byte plane loads issued before its first update; a decoded
slot scatters into other threads' docs between two barriers; only its
postings blocks that meet the half window are decoded, up front with
every other decoded slot's (a warp a block), so their loads overlap. Slots are applied in slot order, so
the f32 sum is taken in the reference's order. Padding rows write -inf
directly. At most 8 slots a query (the executor's flat cap).
Running state in registers instead (a block per 2048-doc chunk, every
(doc, slot) folded by its thread) measured slower on the card: it pays
for every doc of a sparse decoded slot, where the scatter pays per
posting (PERF.md).

``fused_score_tiles`` (replaces ``fused_score_tiles``, ``fusedscore.py:378``,
eval ``eval_tape_tiles``). Non-flat trees (OR-of-AND, slot reuse) with at
most 8 used slots need every slot of a doc at once, so a block owns a
2048-doc eighth of a window and stages each used slot's freqs for that
range in shared memory (8 KiB a slot); a block-wide count over the cells'
first/last docids finds the blocks that meet the range, and only those
are decoded (``stage_slots``). The tape arrives as a register program
(``encode_tape``): the stack depth at each point of a postfix walk does
not depend on the data, so each stack slot becomes a numbered register
and each op names the register it writes (binary ops read it and the
next one). The kernel runs the program once per 4, 2 or 1
docs (for 4, 8 or 16 registers) with the ops unrolled over the registers
and docs, so the registers stay in the register file; a postfix stack
indexed at run time would live in local memory. Each doc's f32 sum is
taken in the tape's association order (0 ulp against the plain version).
Bound: the score tile writes and the staged tiles (cached planes, decoded
blocks); ``score_bytes`` counts them.

On CPU tensors the wrappers run the plain torch versions
(``fused_flat_score_tiles_ref`` / ``fused_score_tiles_ref``); on CUDA
tensors they launch the kernel or raise.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from trinity_tpu_torch.limits import TILE, WINDOW_SIZE
from trinity_tpu_torch.models.similarity import SCORER_CODE, score_tile
from trinity_tpu_torch.ops.postings import (
    _check,
    block_bytes,
    decode_cells,
    materialize_freq_tiles_ref,
)

NEG_INF = float("-inf")
NSUB = 16  # sub-blocks per window (8 tile rows = 1024 contiguous docids)
SUB_DOCS = WINDOW_SIZE // NSUB
MAX_REGS = 16  # registers of the tape kernel's program
MAX_PROG = 64  # program length the tape kernel takes
MAX_FLAT_SLOTS = 8  # slots a query of the flat kernel has (the executor's cap)

# register-program opcodes (csrc/fusedscore.cu); rows are (op, dst, a, b)
(OP_TOK, OP_AND, OP_OR, OP_NOT, OP_UNOT, OP_OPT, OP_SACC, OP_SFIN,
 OP_FALSE) = range(9)
_BINARY = {"and": OP_AND, "or": OP_OR, "not": OP_NOT}


def tape_used_slots(tape) -> tuple:
    """Term slots a boolean tape actually reads (copy of the reference's
    ``fusedscore.py:65-85``, whose module imports jax)."""
    out = set()

    def walk(n):
        kind = n[0]
        if kind == "tok":
            out.add(n[1])
        elif kind in ("and", "or", "not"):
            walk(n[1])
            walk(n[2])
        elif kind in ("unot", "opt"):
            walk(n[1])
        elif kind == "some":
            for c in n[2]:
                walk(c)
        elif kind == "phrase":
            raise ValueError("phrase tapes use the phrase path")

    walk(tape)
    return tuple(sorted(out))


def encode_tape(tape, used):
    """Boolean tape -> (register program (L, 4) i32, register count).

    Rows are (op, dst, a, b). A node is evaluated into register r with the
    registers above r free, so a binary node puts its left child in r, its
    right child in r + 1 and combines them into r: the registers are the
    slots of the postfix stack, numbered where the program is built. TOK
    a = index of the slot in `used` (its staged tile), b = weight index;
    a k-of-n node folds each child after the first into r as soon as it is
    evaluated (SACC: count and f32 sum, in child order, as the reference
    sums them) and ends with SFIN a = kmin. Raises ValueError past the
    kernel's registers or program length."""
    pos = {s: i for i, s in enumerate(used)}
    prog = []

    def emit(n, r):
        """Evaluate n into register r; returns the registers used."""
        kind = n[0]
        if kind == "tok":
            prog.append((OP_TOK, r, pos[n[1]], n[2]))
            return r + 1
        if kind == "false":
            prog.append((OP_FALSE, r, 0, 0))
            return r + 1
        if kind in _BINARY:
            need = max(emit(n[1], r), emit(n[2], r + 1))
            prog.append((_BINARY[kind], r, 0, 0))
            return need
        if kind in ("unot", "opt"):
            need = emit(n[1], r)
            prog.append((OP_UNOT if kind == "unot" else OP_OPT, r, 0, 0))
            return need
        if kind == "some":
            _, kmin, children = n
            need = emit(children[0], r)
            for c in children[1:]:
                need = max(need, emit(c, r + 1))
                prog.append((OP_SACC, r, 0, 0))
            prog.append((OP_SFIN, r, kmin, 0))
            return need
        raise ValueError(f"tape node {kind!r} has no register form")

    nreg = emit(tape, 0)
    if nreg > MAX_REGS or len(prog) > MAX_PROG:
        raise ValueError("tape too deep or too long for the tape kernel")
    return np.asarray(prog, np.int32).reshape(-1, 4), nreg


def eval_program(prog, tiles, wsel, scorer_name):
    """The tape kernel's interpreter in torch: runs a register program
    (``encode_tape``) over whole tiles. tiles: staged-tile index -> f32
    freq tensor; wsel: weight index -> f32 weight (broadcastable). Returns
    (mask bool, score f32) of register 0, as eval_tape_tiles does for the
    tape."""
    m, s = {}, {}
    for op, r, a, b in np.asarray(prog).tolist():
        if op == OP_TOK:
            f = tiles[a]
            m[r] = f > 0
            s[r] = torch.where(m[r], score_tile(scorer_name, f, wsel(b)), 0.0)
        elif op in (OP_AND, OP_OR, OP_NOT):
            if op == OP_NOT:
                mm, ss = m[r] & ~m[r + 1], s[r]
            else:
                mm = m[r] & m[r + 1] if op == OP_AND else m[r] | m[r + 1]
                ss = s[r] + s[r + 1]
            m[r], s[r] = mm, torch.where(mm, ss, 0.0)
        elif op == OP_UNOT:
            m[r], s[r] = ~m[r], torch.zeros_like(s[r])
        elif op == OP_OPT:
            s[r] = torch.where(m[r], s[r], 0.0)
            m[r] = torch.ones_like(m[r])
        elif op == OP_SACC:
            m[r] = m[r].to(torch.int32) + m[r + 1].to(torch.int32)
            s[r] = s[r] + s[r + 1]
        elif op == OP_SFIN:
            mm = m[r].to(torch.int32) >= a
            m[r], s[r] = mm, torch.where(mm, s[r], 0.0)
        else:
            z = torch.zeros_like(next(iter(tiles.values())))
            m[r], s[r] = z > 0, z
    return m[0], s[0]


# ------------------------------------------------------ plain torch versions
def eval_tape_tiles(tape, tiles, wsel, scorer_name, phrase_tiles=()):
    """Torch twin of the reference's ``eval_tape_tiles`` (and of
    ``executor._eval_tape``): identical op order. tiles: slot -> f32 freq
    tensor; wsel: weight index -> f32 weight (broadcastable); phrase_tiles:
    verified phrase-frequency f32 tensors, one per ``phrase`` node in
    ``collect_phrases`` order. Returns (mask bool, score f32), shaped like
    the tiles."""
    # one iterator for the whole walk (iter of an iterator is itself), so
    # the phrase nodes take their tiles in collect_phrases order
    phrase_tiles = iter(phrase_tiles)
    rec = lambda t: eval_tape_tiles(t, tiles, wsel, scorer_name, phrase_tiles)
    kind = tape[0]
    if kind in ("tok", "phrase"):
        if kind == "tok":
            _, slot, widx = tape
            f = tiles[slot]
        else:
            widx = tape[2]
            f = next(phrase_tiles)
        mask = f > 0
        return mask, torch.where(
            mask, score_tile(scorer_name, f, wsel(widx)), 0.0
        )
    if kind in ("and", "or", "not"):
        lm, ls = rec(tape[1])
        rm, rs = rec(tape[2])
        if kind == "and":
            m = lm & rm
            return m, torch.where(m, ls + rs, 0.0)
        if kind == "or":
            m = lm | rm
            return m, torch.where(m, ls + rs, 0.0)
        m = lm & ~rm
        return m, torch.where(m, ls, 0.0)
    if kind == "unot":
        cm, cs = rec(tape[1])
        return ~cm, torch.zeros_like(cs)
    if kind == "opt":
        cm, cs = rec(tape[1])
        return torch.ones_like(cm), torch.where(cm, cs, 0.0)
    if kind == "some":
        _, kmin, children = tape
        cnt = tot = None
        for c in children:
            cm, cs = rec(c)
            ci = cm.to(torch.int32)
            cnt = ci if cnt is None else cnt + ci
            tot = cs if tot is None else tot + cs
        m = cnt >= kmin
        return m, torch.where(m, tot, 0.0)
    if kind == "false":
        z = torch.zeros_like(next(iter(tiles.values())))
        return z > 1, z
    raise ValueError(kind)


def eval_flat_tiles(tiles, flags_of, kmin, wts_of, scorer_name, T):
    """Torch twin of the reference's ``eval_flat_tiles``: mask = (#required
    present >= kmin) & no negated present; score = slot-order f32 sum of
    the present scored (required | optional) members."""
    ssum = cnt = negany = None
    for t in range(T):
        f = tiles[t]
        p = f > 0
        fl = flags_of(t)
        req = (fl & 1) > 0
        neg = (fl & 2) > 0
        scored = (fl & 5) > 0
        s = score_tile(scorer_name, f, wts_of(t))
        contrib = torch.where(p & scored, s, 0.0)
        ssum = contrib if ssum is None else ssum + contrib
        c = (p & req).to(torch.int32)
        cnt = c if cnt is None else cnt + c
        nv = p & neg
        negany = nv if negany is None else negany | nv
    mask = (cnt >= kmin) & ~negany
    return mask, torch.where(mask, ssum, 0.0)


def _slot_tiles(bmeta, planes, cs, cn, cids, tf_planes):
    """(W, B*T, 128, 128) f32 slot tiles: decoded, or the hot-term plane
    for slots with cids >= 0 (whose cn the caller has zeroed)."""
    W = cs.shape[0]
    tiles = materialize_freq_tiles_ref(bmeta, planes, cs, cn)
    hot = torch.nonzero(cids >= 0).reshape(-1)
    if len(hot):
        tiles[:, hot] = tf_planes[cids[hot].long(), :W].transpose(0, 1)
    return tiles


def _epilogue(mask, score, n_docs, deleted):
    """-inf outside the match / segment / deletions; sub-block maxima."""
    B, W = mask.shape[:2]
    dev = score.device
    lid = torch.arange(WINDOW_SIZE, device=dev).reshape(TILE, TILE)
    base = torch.arange(W, device=dev).reshape(W, 1, 1) * WINDOW_SIZE
    in_seg = lid[None] < int(n_docs) - base
    if deleted is not None:
        in_seg = in_seg & (deleted == 0)
    sc = torch.where(mask & in_seg, score, NEG_INF)
    sb = sc.reshape(B, W, NSUB, TILE // NSUB, TILE).amax(dim=3)
    rmax = sb.amax(dim=-1, keepdim=True).expand(B, W, NSUB, TILE)
    return sc.contiguous(), rmax.contiguous()


def fused_flat_score_tiles_ref(
    bmeta, planes, cell_start, cell_nblocks, weights, flags, kmin, cids,
    tf_planes, n_docs, deleted, *, scorer_name,
):
    """Plain torch version of the flat fused kernel."""
    W = cell_start.shape[0]
    B, T = weights.shape
    tiles = _slot_tiles(bmeta, planes, cell_start, cell_nblocks, cids,
                        tf_planes)
    tiles = tiles.reshape(W, B, T, TILE, TILE).transpose(0, 1)
    col = lambda a, t: a[:, t].reshape(B, 1, 1, 1)
    mask, score = eval_flat_tiles(
        [tiles[:, :, t] for t in range(T)], lambda t: col(flags, t),
        kmin.reshape(B, 1, 1, 1), lambda t: col(weights, t), scorer_name, T,
    )
    return _epilogue(mask, score, n_docs, deleted)


def fused_score_tiles_ref(
    bmeta, planes, cell_start, cell_nblocks, weights, cids, tf_planes,
    n_docs, deleted, *, tape, scorer_name,
):
    """Plain torch version of the tape fused kernel."""
    W = cell_start.shape[0]
    B = weights.shape[0]
    T = cell_start.shape[1] // B
    tiles = _slot_tiles(bmeta, planes, cell_start, cell_nblocks, cids,
                        tf_planes)
    tiles = tiles.reshape(W, B, T, TILE, TILE).transpose(0, 1)
    used = tape_used_slots(tape)
    if not used:
        raise ValueError("tape reads no slot")
    mask, score = eval_tape_tiles(
        tape, {t: tiles[:, :, t] for t in used},
        lambda i: weights[:, i].reshape(B, 1, 1, 1), scorer_name,
    )
    return _epilogue(mask, score, n_docs, deleted)


# ----------------------------------------------------------------- wrappers
def _outputs(B, W, dev):
    return (
        torch.empty((B, W, TILE, TILE), dtype=torch.float32, device=dev),
        torch.empty((B, W, NSUB, TILE), dtype=torch.float32, device=dev),
    )


def _check_common(bmeta, planes, cs, cn, cids, tf_planes, deleted, B, T):
    dev = planes.device
    W = cs.shape[0]
    for t, name in ((bmeta, "bmeta"), (planes, "planes"), (cs, "cell_start"),
                    (cn, "cell_nblocks"), (cids, "cids")):
        _check(t, name, torch.int32, dev)
    _check(tf_planes, "tf_planes", torch.float32, dev)
    if cs.shape != (W, B * T) or cn.shape != (W, B * T):
        raise ValueError("cell tables must be (W, B*T)")
    if cids.shape != (B * T,):
        raise ValueError("cids must be (B*T,)")
    if tf_planes.dim() != 4 or tf_planes.shape[2:] != (TILE, TILE):
        raise ValueError("tf_planes must be (C, W_seg, 128, 128)")
    if deleted is not None:
        _check(deleted, "deleted", torch.float32, dev)
        if deleted.shape != (W, TILE, TILE):
            raise ValueError("deleted must be (W, 128, 128)")
    return dev, W


def fused_flat_score_tiles(
    bmeta,  # (rows, 128) i32
    planes,  # (R_pad, 128) i32 bit-view of u32
    cell_start,  # (W, B*T) i32
    cell_nblocks,  # (W, B*T) i32 (0 for cached slots)
    weights,  # (B, T) f32 per-slot weights
    flags,  # (B, T) i32 per-slot 1=required 2=negated 4=optional
    kmin,  # (B,) i32 min required-present count (pad rows: T+1)
    cids,  # (B*T,) i32 hot-cache plane ids (-1 = decode)
    tf_planes,  # (C, W_seg, 128, 128) f32 cached freq planes (or dummy)
    n_docs,  # int
    deleted,  # (W, 128, 128) f32 (1.0 = masked) or None
    *,
    scorer_name: str,
):
    """Flat fused kernel: returns (scores (B, W, 128, 128) f32 with -inf for
    non-matches, sub-block maxima (B, W, 16, 128) f32)."""
    if planes.device.type != "cuda":
        return fused_flat_score_tiles_ref(
            bmeta, planes, cell_start, cell_nblocks, weights, flags, kmin,
            cids, tf_planes, n_docs, deleted, scorer_name=scorer_name,
        )
    from trinity_tpu_torch.utils import kernels

    B, T = weights.shape
    dev, W = _check_common(bmeta, planes, cell_start, cell_nblocks, cids,
                           tf_planes, deleted, B, T)
    _check(weights, "weights", torch.float32, dev)
    _check(flags, "flags", torch.int32, dev)
    _check(kmin, "kmin", torch.int32, dev)
    if flags.shape != (B, T) or kmin.shape != (B,):
        raise ValueError("flags must be (B, T) and kmin (B,)")
    if not 1 <= T <= MAX_FLAT_SLOTS:
        raise ValueError(f"the flat kernel takes 1..{MAX_FLAT_SLOTS} slots")
    for t, name in ((tf_planes, "tf_planes"), (deleted, "deleted")):
        if t is not None and t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")
    scores, rmax = _outputs(B, W, dev)
    if B * W:
        kernels.launch(
            "flat", "trin_flat_score",
            bmeta, planes, cell_start, cell_nblocks, weights, flags, kmin,
            cids, tf_planes, tf_planes.shape[1], int(n_docs), deleted,
            W, B, T, SCORER_CODE[scorer_name], scores, rmax,
        )
    return scores, rmax


@functools.lru_cache(maxsize=256)
def _program(tape, device):
    used = tape_used_slots(tape)
    prog, nreg = encode_tape(tape, used)
    return (torch.from_numpy(prog.reshape(-1)).to(device), nreg,
            torch.tensor(used, dtype=torch.int32, device=device))


def fused_score_tiles(
    bmeta,  # (rows, 128) i32
    planes,  # (R_pad, 128) i32 bit-view of u32
    cell_start,  # (W, B*T) i32
    cell_nblocks,  # (W, B*T) i32 (0 for cached slots)
    weights,  # (B, NW) f32
    cids,  # (B*T,) i32 hot-cache plane ids (-1 = decode)
    tf_planes,  # (C, W_seg, 128, 128) f32 cached freq planes (or dummy)
    n_docs,  # int
    deleted,  # (W, 128, 128) f32 (1.0 = masked) or None
    *,
    tape,
    scorer_name: str,
):
    """Tape fused kernel (at most 8 used slots): same outputs as
    fused_flat_score_tiles."""
    if planes.device.type != "cuda":
        return fused_score_tiles_ref(
            bmeta, planes, cell_start, cell_nblocks, weights, cids,
            tf_planes, n_docs, deleted, tape=tape, scorer_name=scorer_name,
        )
    from trinity_tpu_torch.utils import kernels

    B, NW = weights.shape
    T = cell_start.shape[1] // max(1, B)
    dev, W = _check_common(bmeta, planes, cell_start, cell_nblocks, cids,
                           tf_planes, deleted, B, T)
    _check(weights, "weights", torch.float32, dev)
    prog, nreg, used = _program(tape, dev)
    U = len(used)
    if not 1 <= U <= 8:
        raise ValueError("the tape kernel takes 1..8 used slots")
    scores, rmax = _outputs(B, W, dev)
    if B * W:
        kernels.launch(
            "tape", "trin_tape_score",
            bmeta, planes, cell_start, cell_nblocks, weights, NW, cids,
            prog, len(prog) // 4, nreg, used, U, tf_planes,
            tf_planes.shape[1], int(n_docs), deleted, W, B, T,
            SCORER_CODE[scorer_name], scores, rmax,
        )
    return scores, rmax


# ------------------------------------------------------------ byte counts
def score_bytes(bmeta, planes, cell_start, cell_nblocks, cids, B, deleted,
                n_weights):
    """(bytes, f32 operations) one fused score call (flat or tape) must
    move and do: the scores and sub-block maxima written once
    (B * W * (16384 + 2048) f32), the cell tables, cids and per-query
    inputs (weights, and for flat calls flags and kmin: `n_weights` values
    a row), the distinct decoded blocks (block_bytes), each distinct hot
    plane tile read (64 KiB per (cid, window)) and the deletion tiles.
    Operations: 3 (score) + 1 (sum) per posting the call scores, counting
    the postings of the decoded cells in their windows; cached slots are
    not counted (an undercount only lowers the operations bound)."""
    W = cell_start.shape[0]
    hot = torch.unique(cids[cids >= 0])
    nbytes = (B * W * (WINDOW_SIZE + NSUB * TILE) * 4
              + 2 * cell_start.numel() * 4 + cids.numel() * 4
              + B * int(n_weights) * 4
              + block_bytes(bmeta, cell_start, cell_nblocks)
              + len(hot) * W * WINDOW_SIZE * 4
              + (0 if deleted is None else deleted.numel() * 4))
    T = cell_start.shape[1]
    cell, docs, _, _, valid = decode_cells(bmeta, planes, cell_start,
                                           cell_nblocks)
    local = docs - (cell // T)[:, None] * WINDOW_SIZE
    postings = int((valid & (local >= 0) & (local < WINDOW_SIZE)).sum())
    return nbytes, 4 * postings


# ------------------------------------------------------------ exact top-k
def topk_lowest_index(x, k):
    """Top-k along dim 1 by (value desc, index asc) — the tie rule of
    ``lax.top_k``, which ``torch.topk`` does not promise."""
    v, i = torch.sort(x, dim=1, descending=True, stable=True)
    return v[:, :k], i[:, :k]


def exact_window_topk(scores, rmax, k, sel_blocks=16):
    """Two-phase exact top-k with the docid-asc tie-break (the reference's
    ``exact_window_topk``): select the top sub-blocks by (max desc, index
    asc), gather them in ascending order, then one small flat top-k.

    scores: (B, W, 128, 128) f32; rmax: (B, W, 16, 128) f32. Returns
    (values (B, k) f32, local docids (B, k) int64)."""
    B, W = rmax.shape[:2]
    nblk = W * NSUB
    flat = scores.reshape(B, nblk, SUB_DOCS)
    bmax = rmax[:, :, :, 0].reshape(B, nblk)
    kap = min(nblk, max(16, k, sel_blocks))
    if kap < nblk:
        _, sel = topk_lowest_index(bmax, kap)
        sel = torch.sort(sel, dim=1).values  # flat order = docid order
        g = torch.gather(flat, 1, sel[:, :, None].expand(B, kap, SUB_DOCS))
    else:
        sel = torch.arange(nblk, device=scores.device).expand(B, nblk)
        g = flat
    gv, gidx = topk_lowest_index(g.reshape(B, -1), k)
    blk = torch.gather(sel, 1, gidx // SUB_DOCS)
    return gv, blk * SUB_DOCS + gidx % SUB_DOCS
