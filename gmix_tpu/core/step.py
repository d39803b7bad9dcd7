"""The fused codec step: the reference's Predict/Encode/Perceive/Learn bit
loop (src/runner/runner-utils.cpp:50-65) restructured as one scanned,
stream-batched device program.

Key design properties (SURVEY.md 7):

- Scan is over BYTES; the 8 bit sub-steps are ONE shared body instantiated
  either statically unrolled (j-dependent selects fold away; no inner loop)
  or as a lax.scan over bits (~8x smaller graph, fast cold compiles;
  default_bit_scan picks per backend). There is NO lax.cond in the per-bit
  path: an identity cond branch carrying a multi-MB tensor (LSTM weight
  histories, PPM tables) can force a physical copy per iteration.
  Byte-boundary work simply runs first and byte-end work last.
- All per-bit model state whose gating context is byte-stable (all indirect
  models, 27 of 33 mixers, the match tables) is gathered once per byte as
  contiguous rows, updated in registers across the sub-steps with dense
  one-hot selects, and scattered back once per byte, instead of per-bit
  element scatters into the GB-scale arenas.
- Truncated-BPTT fires when the LSTM epoch counter wraps, i.e. at statically
  known byte positions (every `horizon` bytes). When the scan chunk is a
  multiple of the horizon, the scan nests as [segments x horizon bytes] and
  BPTT runs unconditionally at each segment end (provably equivalent: the
  output-layer SGD and BPTT touch disjoint state). Non-aligned chunks fall
  back to a lax.cond with minimal operands (test/debug path).
- Learning on/off is a TRACE-TIME choice: the generation program simply
  contains no Learn code at all (reference contract: generation never calls
  Learn, runner-utils.cpp:196-215, and LSTM Perceive is skipped,
  lstm-model.cpp:50-59), so freezing long-term memory is structural.
- Encode and decode are the same traced program; `decode` is a traced scalar
  selecting the bit source, making encoder/decoder model-state divergence
  structurally impossible.
- No dot: every inexact float reduction and contraction is a fixed binary
  tree of f32 adds (_tree_sum), so an encoder and a decoder compiled in
  different processes, at different stream-batch shapes or on different
  backends sum in the same order.
- Every model family lives in ONE flat arena (core/meta.py), so the per-bit
  hot path is a handful of batched gathers/scatters with provably unique
  indices (`unique_indices=True`).
- The 33-mixer GLN's "earlier mixers in the same layer" term
  (mixer.cpp:60-64) is a strictly-lower-triangular linear system per layer,
  solved by nilpotent doubling instead of a 24-step sequential chain.
- The reference's active-model protocol (short-term-memory.cpp:187-197: a
  model predicting exactly logit 0 is excluded from mixing and updates) is
  realised densely: a 0 logit contributes 0 to every mixer dot product and
  receives a 0 weight update, so no index lists are needed.
- Ops touching the big per-stream LSTM tensors (out_w weight history) use
  explicit multiply+reduce on a dynamic_slice of the scalar epoch, not
  batched gather/scatter indexing, so no layout-conversion copy of the
  whole history is needed per byte.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..config import EnsembleSpec
from ..ops import coder as coder_ops
from ..ops.rowmove import gather_rows, scatter_rows
from ..ops.murmur import murmur3_u32, murmur3_u64
from ..ops.sigmoid import (
    clamp_prob,
    exp_det,
    logistic,
    logit,
    pow_det,
    powc_det,
    tanh_det,
)
from ..ops.tables import nonstationary_table, run_map_table
from .meta import APM_BINS, APM_SPAN, Meta, PPM_ROW_W, PPM_TAG_LANE, ROLL_BASE

F32 = jnp.float32
U32 = jnp.uint32
I32 = jnp.int32


def _set(d: Dict, **kw) -> Dict:
    out = dict(d)
    out.update(kw)
    return out


def _iar(x: jnp.ndarray) -> jnp.ndarray:
    """uint -> int32 for indexing."""
    return x.astype(I32)


# ---------------------------------------------------------------------------
# byte-boundary work
# ---------------------------------------------------------------------------


def _boundary(stm: Dict, ltm: Dict, t: jnp.ndarray, meta: Meta) -> Tuple[Dict, Dict]:
    spec = meta.spec
    S = stm["bits_seen"].shape[0]
    s_ix = jnp.arange(S)[:, None]
    not_first = t > 0

    # --- complete the previous byte (BasicContexts::ByteUpdate) ---
    completed = stm["acc"]

    # --- PPM count update with the completed byte, against the PRE-update
    # contexts (mirrors ModPPMD::Predict's ppmd_UpdateByte(last_byte) at the
    # byte boundary, mod_ppmd.cpp:1649-1660) ---
    if spec.ppm is not None:
        stm = _ppm_update(stm, completed, meta)

    last_byte = jnp.where(not_first, completed, stm["last_byte"])
    recent = jnp.where(
        not_first,
        jnp.concatenate([completed[:, None], stm["recent"][:, :-1]], axis=1),
        stm["recent"],
    )
    ctx = stm["ctx"]
    # last_byte + recent_1..9 context slots in one static-index write
    ctx = ctx.at[:, jnp.asarray(meta.byte_ctx_cols)].set(
        jnp.concatenate([last_byte[:, None], recent[:, 1:10]], axis=1)
    )

    # --- interval contexts (interval-context.cpp:17-23) ---
    if spec.interval_ctxs:
        maps = jnp.asarray(meta.interval_maps, I32)  # (NI, 256)
        vals = jnp.take(maps, _iar(last_byte), axis=1).T.astype(U32)  # (S, NI)
        islots = meta.interval_slots
        old = ctx[:, islots]
        shifts = jnp.asarray(meta.interval_shifts, U32)[None, :]
        masks = jnp.asarray(meta.interval_masks, U32)[None, :]
        ctx = ctx.at[:, islots].set(masks & ((old << shifts) + vals))

    # --- skip hashes (skip-context.cpp:9-19), all instances in one batch ---
    if spec.skip_ctxs:
        bg = recent[:, jnp.asarray(meta.skip_gather)]  # (S, NSK, MAX_SKIP) u32
        lo = jnp.sum(
            jnp.where(jnp.asarray(meta.skip_lo_on), bg << jnp.asarray(meta.skip_lo_sh), U32(0)),
            axis=2, dtype=U32,
        )
        hi = jnp.sum(
            jnp.where(jnp.asarray(meta.skip_hi_on), bg << jnp.asarray(meta.skip_hi_sh), U32(0)),
            axis=2, dtype=U32,
        )
        ctx = ctx.at[:, jnp.asarray(meta.skip_slots)].set(murmur3_u64(lo, hi))

    # --- rolling-hash contexts (deep PPM orders): O(1) Rabin-Karp update
    # h' = (h - leaving*B^(n-1))*B + completed over the pre-shift recent ring,
    # published murmur-finalised (see config.RollHashCtx) ---
    if spec.roll_ctxs:
        old_b = stm["recent"][:, jnp.asarray(meta.roll_old_ix)]  # (S, NR) pre-shift
        pows = jnp.asarray(meta.roll_pows)[None, :]
        h_new = (stm["roll_h"] - old_b * pows) * U32(ROLL_BASE) + completed[:, None]
        h_new = jnp.where(not_first, h_new, stm["roll_h"])
        ctx = ctx.at[:, jnp.asarray(meta.roll_slots)].set(murmur3_u32(h_new))
        stm = _set(stm, roll_h=h_new)

    # --- indirect-hash contexts (indirect-hash.cpp:16-31), one flat arena ---
    if spec.ihash_ctxs:
        f = stm["ih_tbl"]  # (S, TOT)
        offs = jnp.asarray(meta.ih_offsets)[None, :]
        ih_masks = jnp.asarray(meta.ih_masks)[None, :]
        old_idx = _iar(stm["ih_outer_hash"] & ih_masks) + offs
        inner = f[s_ix, old_idx]  # (S, NIH)
        imask = jnp.asarray(meta.ih_inner_mods)[None, :] - U32(1)
        inner_new = ((inner & imask) << U32(8)) + last_byte[:, None]
        f = f.at[s_ix, old_idx].set(inner_new, unique_indices=True)
        omask = jnp.asarray(meta.ih_outer_mods)[None, :] - U32(1)
        outer_new = ((stm["ih_outer_ctx"] & omask) << U32(8)) + last_byte[:, None]
        new_hash = murmur3_u64(outer_new, jnp.zeros_like(outer_new))
        new_idx = _iar(new_hash & ih_masks) + offs
        out_ctx = murmur3_u32(f[s_ix, new_idx])
        ctx = ctx.at[:, jnp.asarray(meta.ih_out_slots)].set(out_ctx)
        stm = _set(stm, ih_tbl=f, ih_outer_ctx=outer_new, ih_outer_hash=new_hash)

    stm = _set(stm, last_byte=last_byte, recent=recent, acc=jnp.zeros_like(completed), ctx=ctx)

    # --- PPM next-byte distribution from the updated contexts (fills
    # ppm_probs, which the LSTM consumes as aux input) ---
    if spec.ppm is not None:
        stm = _ppm_predict(stm, meta)

    # --- LSTM byte forward (lstm.cpp:91-122, lstm-layer.cpp:198-241) ---
    if spec.lstm is not None:
        stm, ltm = _lstm_forward(stm, ltm, meta)

    return stm, ltm


def _ppm_rows(stm: Dict, ctx: jnp.ndarray, meta: Meta):
    """Row indices, gathered count rows, context tags, stored tags, and the
    tag-match mask of the PPM arena for the current contexts.

    Rows are TAG-VERIFIED: lane PPM_TAG_LANE of each row stores the high hash
    byte of the context that owns it; a mismatch means a hash collision and
    the row reads as empty (and is reclaimed on update). This turns the hashed
    tables into 1-way caches - collisions become evictions instead of
    histogram pollution, which is what lets hashed fixed-order tables stand in
    for the reference's exact 2 GB suffix tree (mod_ppmd.cpp:126-330) at deep
    orders. The tag RIDES IN THE ROW (lane 256 of the widened row) instead of
    a separate (S, rows) array, so one row write carries counts and tag: one
    scatter call and S*NO element writes fewer per byte."""
    S = ctx.shape[0]
    cv = ctx[:, jnp.asarray(meta.ppm_slots)]
    h = _iar(cv & jnp.asarray(meta.ppm_masks)[None, :])
    h = h + jnp.asarray(meta.ppm_row_offsets)[None, :]
    raw_rows = gather_rows(stm["ppm_tbl"], h)  # (S, NO, PPM_ROW_W)
    my_tag = ((cv >> U32(24)) & U32(255)).astype(jnp.uint16)
    old_tag = raw_rows[:, :, PPM_TAG_LANE]
    tag_ok = my_tag == old_tag
    rows = jnp.where(tag_ok[:, :, None], raw_rows[:, :, :256], jnp.uint16(0))
    return h, rows, my_tag, old_tag, tag_ok, raw_rows


def _ppm_cascade(rows_f: jnp.ndarray, see: jnp.ndarray, sp):
    """Shared top-down exclusion cascade over the PPM orders.

    rows_f: (S, NO, 256) float counts, lowest order at index 0; see:
    (S, NO, NB) learned escape-logit offsets. Returns per-order lists (index =
    order position) of masked rows, totals, has-flags, adaptive escape probs
    and SEE bucket one-hots, plus the final exclusion mask.

    Mirrors PPMd's prediction walk (mod_ppmd.cpp:1192-1220): highest order
    first; symbols seen at a processed order are excluded from every lower
    order's counts AND escape statistics (the exclusion list); the escape
    probability is the PPM-C prior distinct/(total+distinct) bent by a learned
    per-(order, distinct-bucket) logistic offset (SEE, mod_ppmd.cpp:465-496).
    """
    S, NO, _ = rows_f.shape
    NB = sp.see_buckets
    excl = jnp.zeros((S, 256), jnp.bool_)
    mrow = [None] * NO
    total = [None] * NO
    has = [None] * NO
    esc = [None] * NO
    bucket_oh = [None] * NO
    for i in range(NO - 1, -1, -1):
        row = jnp.where(excl, F32(0.0), rows_f[:, i]) if sp.exclusion else rows_f[:, i]
        t = _tree_sum(row)
        distinct = jnp.sum(row > 0, axis=1).astype(F32)
        h = t > 0
        ppmc = distinct / jnp.maximum(t + distinct, F32(1.0))
        oh = jax.nn.one_hot(
            jnp.minimum(distinct.astype(I32), NB - 1), NB, dtype=F32
        )
        adj = jnp.sum(see[:, i] * oh, axis=1)
        e = logistic(logit(ppmc) + adj)
        mrow[i], total[i], has[i], esc[i], bucket_oh[i] = row, t, h, e, oh
        if sp.exclusion:
            excl = excl | (rows_f[:, i] > 0)
    return mrow, total, has, esc, bucket_oh, excl


def _ppm_update(stm: Dict, completed: jnp.ndarray, meta: Meta) -> Dict:
    """Per-byte PPM learn: SEE escape-correction update, PPMd-style update
    exclusion, count increment + rescale (reference: ppmd_UpdateByte at the
    byte boundary, mod_ppmd.cpp:1649-1660, 498-660)."""
    sp = meta.spec.ppm
    S = completed.shape[0]
    NO = len(sp.orders)
    h, rows, my_tag, old_tag, tag_ok, raw_rows = _ppm_rows(stm, stm["ctx"], meta)
    rows_f = rows.astype(F32)
    see = stm["ppm_see"]
    mrow, total, has, esc, bucket_oh, _ = _ppm_cascade(rows_f, see, sp)

    c_oh = jax.nn.one_hot(_iar(completed), 256, dtype=F32)  # (S, 256)
    # found_i: the byte was codable at order i under exclusion; the cascade
    # stops at the highest found order ("coded"), so orders below it were
    # never exercised and orders above it all escaped.
    found = [has[i] & (jnp.sum(mrow[i] * c_oh, axis=1) > 0) for i in range(NO)]
    higher_found = [None] * NO  # any found at order > i
    hf = jnp.zeros((S,), jnp.bool_)
    for i in range(NO - 1, -1, -1):
        higher_found[i] = hf
        hf = hf | found[i]

    # SEE learn: for exercised orders, esc moves toward the observed escape
    # event (1 above the coded order, 0 at it)
    upd = []
    for i in range(NO):
        exercised = has[i] & jnp.logical_not(higher_found[i])
        target = jnp.logical_not(found[i]).astype(F32)
        delta = jnp.where(exercised, F32(sp.see_lr) * (target - esc[i]), F32(0.0))
        upd.append(bucket_oh[i] * delta[:, None])
    see = see + jnp.stack(upd, axis=1)

    # count update: orders at/above the coded order only (update exclusion)
    if sp.update_exclusion:
        inc_on = jnp.stack(
            [jnp.logical_not(higher_found[i]) for i in range(NO)], axis=1
        )  # (S, NO)
    else:
        inc_on = jnp.ones((S, NO), jnp.bool_)
    rows_i = rows.astype(I32) + jnp.where(
        inc_on[:, :, None], _iar(c_oh)[:, None, :] * sp.inc, 0
    )
    tot_i = jnp.sum(rows_i, axis=2)
    rows_i = jnp.where((tot_i > sp.rescale_total)[:, :, None], (rows_i + 1) >> 1, rows_i)
    # updated rows are (re)claimed for this context's tag; untouched rows keep
    # their owner's counts and tag (`rows` already reads 0 on tag mismatch, so
    # a reclaimed row starts from just the observed byte). Counts + tag ride
    # one widened row write (see _ppm_rows).
    counts_w = jnp.where(inc_on[:, :, None], rows_i.astype(jnp.uint16), raw_rows[:, :, :256])
    tag_w = jnp.where(inc_on, my_tag, old_tag)
    NO_w = counts_w.shape[1]
    pad = jnp.zeros((S, NO_w, PPM_ROW_W - 257), jnp.uint16)
    full_w = jnp.concatenate([counts_w, tag_w[:, :, None], pad], axis=2)
    tbl = scatter_rows(stm["ppm_tbl"], h, full_w)
    return _set(stm, ppm_tbl=tbl, ppm_see=see)


def _ppm_predict(stm: Dict, meta: Meta) -> Dict:
    """Next-byte distribution: highest order first with symbol exclusion and
    adaptive escapes; leftover mass goes uniformly to unseen symbols
    (the order-(-1) model, mod_ppmd.cpp:1322-1384)."""
    sp = meta.spec.ppm
    S = stm["bits_seen"].shape[0]
    NO = len(sp.orders)
    _, rows, _, _, _, _ = _ppm_rows(stm, stm["ctx"], meta)
    rows_f = rows.astype(F32)
    mrow, total, has, esc, _, excl = _ppm_cascade(rows_f, stm["ppm_see"], sp)

    p = jnp.zeros((S, 256), F32)
    w = jnp.ones((S,), F32)
    for i in range(NO - 1, -1, -1):
        contrib = jnp.where(has[i], w * (F32(1.0) - esc[i]), F32(0.0))
        p = p + contrib[:, None] * mrow[i] / jnp.maximum(total[i], F32(1.0))[:, None]
        w = jnp.where(has[i], w * esc[i], w)
    # order -1: uniform over non-excluded symbols; all-excluded -> uniform all
    nex = jnp.sum(jnp.logical_not(excl).astype(F32), axis=1)
    uni = jnp.where(
        (nex > 0)[:, None],
        jnp.logical_not(excl).astype(F32) / jnp.maximum(nex, F32(1.0))[:, None],
        F32(1.0 / 256),
    )
    p = p + w[:, None] * uni
    return _set(
        stm,
        ppm_probs=p,
        ppm_top=jnp.full((S,), 255, I32),
        ppm_bot=jnp.zeros((S,), I32),
    )


def _interval_bit_pred(probs, top, bot, mid, new_bit, first):
    """Byte-distribution -> per-bit probability via the narrowing [bot, top]
    interval (lstm-model.cpp:17-48; ModPPMD uses the identical scheme).
    `first` (python bool or traced bool) marks bit sub-step 0, where the
    interval was just reset. Returns (masked logit, top, bot, mid)."""
    if isinstance(first, bool):
        if not first:
            nb = new_bit.astype(I32)
            bot = jnp.where(nb == 1, mid + 1, bot)
            top = jnp.where(nb == 1, top, mid)
    else:
        nb = new_bit.astype(I32)
        upd = jnp.logical_not(first)
        bot = jnp.where(upd & (nb == 1), mid + 1, bot)
        top = jnp.where(upd & (nb == 0), mid, top)
    mid = bot + (top - bot) // 2
    ar = jnp.arange(256)[None, :]
    num = _tree_sum(jnp.where((ar >= mid[:, None] + 1) & (ar <= top[:, None]), probs, 0.0))
    den = num + _tree_sum(jnp.where((ar >= bot[:, None]) & (ar <= mid[:, None]), probs, 0.0))
    p = jnp.where(den != 0, num / jnp.where(den != 0, den, 1.0), F32(0.5))
    return jnp.where(den != 0, logit(p), F32(0.0)), top, bot, mid


def _lstm_forward(stm: Dict, ltm: Dict, meta: Meta) -> Tuple[Dict, Dict]:
    ls = meta.spec.lstm
    lw, lst = ltm["lstm"], stm["lstm"]
    C, Hz = ls.num_cells, ls.horizon
    S = stm["bits_seen"].shape[0]
    e = lst["epoch"]

    aux = stm["ppm_probs"]  # (S, 256): PPM byte distribution (uniform when PPM off)
    li = jnp.concatenate(
        [aux, lst["hidden"][:, :C], jnp.ones((S, 1), F32)], axis=1
    )  # (S, LI) = stored layer input
    sym = _iar(stm["last_byte"])

    # symbol embedding column + dense input transform (lstm-layer.cpp:222-241);
    # the weight matrix is stored split (w_sym | w_in) so neither op slices it
    w_sym = jnp.take_along_axis(lw["w_sym"], sym[:, None, None, None], axis=3)[..., 0]  # (S,3,C)
    f = w_sym + _tree_sum(lw["w_in"] * li[:, None, None, :])
    # 1/sqrt, not rsqrt: sqrt and divide are correctly rounded on every
    # backend, rsqrt is a backend approximation
    ivar = F32(1.0) / jnp.sqrt(_tree_sum(f * f) / F32(C) + F32(1e-5))  # (S,3)
    norm = f * ivar[:, :, None]
    pre = norm * lw["gamma"] + lw["beta"]
    # tanh/exp/logistic here are the deterministic polynomial kernels
    # (ops/sigmoid.py): backend transcendentals round differently per array
    # SHAPE, which broke stream-batch-size-invariant archives
    forget = logistic(pre[:, 0])
    innode = tanh_det(pre[:, 1])
    outg = logistic(pre[:, 2])
    in_gate = F32(1.0) - forget  # CIFG (lstm-layer.cpp:212)
    last_state = lst["cell"]
    cell = last_state * forget + innode * in_gate
    tanh_c = tanh_det(cell)
    hidden = jnp.concatenate([outg * tanh_c, jnp.ones((S, 1), F32)], axis=1)

    # per-epoch output layer (lstm.cpp:91-122); out_w is (S, Hz, C+1, OUT)
    # with OUT minor and is sliced with dynamic_slice on the scalar epoch
    # (see the module docstring on layout copies)
    w_e = jax.lax.dynamic_index_in_dim(lw["out_w"], e, 1, keepdims=False)  # (S, C+1, OUT)
    logits = _tree_sum(w_e * hidden[:, :, None], axis=1)
    maxv = jnp.maximum(jnp.max(logits, axis=1, keepdims=True), F32(0.0))  # lstm.cpp:105-113
    probs = exp_det(logits - maxv)
    probs = probs / _tree_sum(probs)[:, None]

    gate_state = jnp.stack([forget, innode, outg], axis=1)  # (S,3,C)
    lst = _set(
        lst,
        layer_input=lst["layer_input"].at[:, e].set(li),
        norm=lst["norm"].at[:, :, e].set(norm),
        ivar=lst["ivar"].at[:, :, e].set(ivar),
        gate_state=lst["gate_state"].at[:, :, e].set(gate_state),
        tanh_state=lst["tanh_state"].at[:, e].set(tanh_c),
        in_gate=lst["in_gate"].at[:, e].set(in_gate),
        last_state=lst["last_state"].at[:, e].set(last_state),
        outputs=lst["outputs"].at[:, e].set(probs),
        cell=cell,
        hidden=hidden,
        probs=probs,
        top=jnp.full((S,), 255, I32),
        bot=jnp.zeros((S,), I32),
        epoch=(e + 1) % Hz,
    )
    ctx = stm["ctx"].at[:, meta.slots["lstm_ctx"]].set(jnp.argmax(probs, axis=1).astype(U32))
    return _set(stm, lstm=lst, ctx=ctx), ltm


def _lstm_bptt(lst: Dict, lw: Dict, meta: Meta) -> Tuple[Dict, Dict]:
    """Horizon-window backward pass + Adam (LstmLayer::BackwardPass,
    lstm-layer.cpp:252-354; Adam lstm-layer.cpp:12-34). Runs when the epoch
    counter wraps; reads the recorded forward history, updates gate weights."""
    ls = meta.spec.lstm
    C, Hz, OUT = ls.num_cells, ls.horizon, ls.output_size
    LI = ls.input_size + C + 1
    S = lst["cell"].shape[0]
    clip = F32(ls.grad_clip)
    in_hist = lst["in_hist"]
    gamma, beta = lw["gamma"], lw["beta"]

    def epoch_step(carry, epoch):
        stored, state_err, upd_sym, upd_in, upd_g, upd_b = carry
        out_err = lst["outputs"][:, epoch] - jax.nn.one_hot(in_hist[:, epoch], OUT, dtype=F32)
        # multiply+reduce over the 256 symbols (see layout note in _lstm_forward)
        w_e = jax.lax.dynamic_index_in_dim(lw["out_w"], epoch, 1, keepdims=False)
        he = _tree_sum(out_err[:, None, :] * w_e[:, :C, :])
        is_last = epoch == (Hz - 1)
        stored = jnp.where(is_last, he, stored + he)
        state_err = jnp.where(is_last, jnp.zeros_like(state_err), state_err)

        fg = lst["gate_state"][:, 0, epoch]
        inn = lst["gate_state"][:, 1, epoch]
        og = lst["gate_state"][:, 2, epoch]
        ts = lst["tanh_state"][:, epoch]
        ig = lst["in_gate"][:, epoch]
        out_err_g = ts * stored * og * (1.0 - og)
        state_err = state_err + stored * og * (1.0 - ts * ts)
        in_err = state_err * ig * (1.0 - inn * inn)
        fg_err = (lst["last_state"][:, epoch] - inn) * state_err * fg * ig

        not_first = epoch > 0
        state_err = jnp.where(not_first, state_err * fg, state_err)
        stored_next = jnp.where(not_first, jnp.zeros_like(stored), stored)

        errs = jnp.stack([fg_err, in_err, out_err_g], axis=1)  # (S,3,C)
        norm = lst["norm"][:, :, epoch]  # (S,3,C)
        ivar = lst["ivar"][:, :, epoch]  # (S,3)
        upd_g = upd_g + errs * norm
        upd_b = upd_b + errs
        err2 = errs * gamma * ivar[:, :, None]
        err2 = err2 - (_tree_sum(err2 * norm)[:, :, None] / C) * norm
        # hidden backprop through the hidden block of the weight rows
        # (transpose_[i][j] = weights[j][OUT+IN+i], lstm-layer.cpp:311,330-338)
        w_hid = lw["w_in"][:, :, :, ls.input_size : ls.input_size + C]  # (S,3,C,C)
        hid_grad = _tree_sum(_tree_sum(err2[..., None] * w_hid, axis=2), axis=1)
        stored_next = jnp.where(not_first, stored_next + hid_grad, stored_next)

        # gradient accumulation: d w[i, sym] += err_i ; d w[i, OUT+j] += err_i * input_j
        in_sym = jnp.where(epoch > 0, in_hist[:, (epoch - 1) % Hz], lst["old_input"])
        li = lst["layer_input"][:, epoch]  # (S, LI)
        upd_in = upd_in + err2[..., None] * li[:, None, None, :]
        onehot = jax.nn.one_hot(in_sym, OUT, dtype=F32)
        upd_sym = upd_sym + err2[..., None] * onehot[:, None, None, :]

        state_err = jnp.clip(state_err, -clip, clip)
        stored_next = jnp.clip(stored_next, -clip, clip)
        return (stored_next, state_err, upd_sym, upd_in, upd_g, upd_b), ()

    init = (
        lst["stored_err"],
        lst["state_err"],
        jnp.zeros((S, 3, C, OUT), F32),
        jnp.zeros((S, 3, C, LI), F32),
        jnp.zeros((S, 3, C), F32),
        jnp.zeros((S, 3, C), F32),
    )
    (stored, state_err, upd_sym, upd_in, upd_g, upd_b), _ = jax.lax.scan(
        epoch_step, init, jnp.arange(Hz - 1, -1, -1)
    )

    t_new = jnp.minimum(lst["update_steps"] + 1, ls.update_limit)
    tf = t_new.astype(F32)
    # 1/sqrt instead of rsqrt: sqrt and divide are IEEE-correctly-rounded
    # (shape-invariant); rsqrt is a backend approximation
    alpha = F32(ls.lr * 0.1) / jnp.sqrt(F32(5e-5) * tf + F32(1.0))
    b1, b2, eps = F32(ls.adam_beta1), F32(ls.adam_beta2), F32(ls.adam_eps)

    def adam(g, m, v, w):
        m = b1 * m + (1.0 - b1) * g
        v = b2 * v + (1.0 - b2) * g * g
        mh = m / (1.0 - powc_det(ls.adam_beta1, tf))
        vh = v / (1.0 - powc_det(ls.adam_beta2, tf))
        return m, v, w - alpha * mh / jnp.sqrt(vh + eps)

    sm, sv, w_sym = adam(upd_sym, lw["sym_m"], lw["sym_v"], lw["w_sym"])
    im, iv, w_in = adam(upd_in, lw["in_m"], lw["in_v"], lw["w_in"])
    gm, gv, gamman = adam(upd_g, lw["gamma_m"], lw["gamma_v"], gamma)
    bm, bv, betan = adam(upd_b, lw["beta_m"], lw["beta_v"], beta)
    lw2 = _set(lw, w_sym=w_sym, sym_m=sm, sym_v=sv, w_in=w_in, in_m=im, in_v=iv,
               gamma=gamman, gamma_m=gm, gamma_v=gv, beta=betan, beta_m=bm, beta_v=bv)
    lst2 = _set(lst, stored_err=stored, state_err=state_err,
                update_steps=t_new)
    return lst2, lw2


def _lstm_perceive(stm: Dict, ltm: Dict, inp: jnp.ndarray, meta: Meta, bptt_mode: str):
    """Lstm::Perceive (lstm.cpp:52-89): record the observed symbol, run the
    per-byte output-layer SGD, and (mode 'cond') the wrap-triggered BPTT.
    In mode 'defer' the BPTT is hoisted to the enclosing segment scan, which
    is equivalent: it exchanges no state with the output-layer SGD."""
    ls = meta.spec.lstm
    lst, lw = stm["lstm"], ltm["lstm"]
    Hz, OUT = ls.horizon, ls.output_size
    e_cur = lst["epoch"]
    last_e = (e_cur - 1) % Hz
    old_input = lst["in_hist"][:, last_e]
    lst = _set(
        lst,
        in_hist=lst["in_hist"].at[:, last_e].set(inp),
        # the symbol that preceded epoch 0 of the NEXT window (consumed by BPTT)
        old_input=jnp.where(e_cur == 0, old_input, lst["old_input"]),
    )

    if bptt_mode == "cond":
        lst, lw = jax.lax.cond(
            e_cur == 0, lambda a: _lstm_bptt(a[0], a[1], meta), lambda a: a, (lst, lw)
        )

    # per-byte output-layer SGD (lstm.cpp:81-88): copies last epoch's weights
    # into the current slot and applies the step (dynamic_slice on the scalar
    # epoch index; see layout note in _lstm_forward)
    err = jax.lax.dynamic_index_in_dim(lst["outputs"], last_e, 1, keepdims=False) - (
        jax.nn.one_hot(inp, OUT, dtype=F32)
    )
    w_last = jax.lax.dynamic_index_in_dim(lw["out_w"], last_e, 1, keepdims=False)  # (S, C+1, OUT)
    w_new = w_last - F32(ls.lr) * lst["hidden"][:, :, None] * err[:, None, :]
    out_w = jax.lax.dynamic_update_slice_in_dim(lw["out_w"], w_new[:, None], e_cur, axis=1)
    return _set(stm, lstm=lst), _set(ltm, lstm=_set(lw, out_w=out_w))


# ---------------------------------------------------------------------------
# per-byte step (8 statically unrolled bit sub-steps)
# ---------------------------------------------------------------------------

_NS_NEXT = nonstationary_table()
_RM_NEXT = run_map_table()
# match-model bit masks by sub-step: the check mask tests the PREVIOUS bit
# (match.cpp:29 runs before bit_pos_ /= 2), the pred mask the current one.
_CHECK_MASKS = np.array([1, 128, 64, 32, 16, 8, 4, 2], np.uint32)
_PRED_MASKS = np.array([128, 64, 32, 16, 8, 4, 2, 1], np.uint32)

# coder window: per byte the coder consumes/emits at most 32 renorm bytes
# (4 per bit) + a 4-byte decoder lookahead; the window is read from / written
# to code_buf ONCE per byte, and the per-bit accesses are register one-hots.
_CODER_WIN = 40



def _tree_sum(x: jnp.ndarray, axis: int = -1) -> jnp.ndarray:
    """Sum over `axis` (default the last) with an explicit fixed binary tree.

    jnp.sum/einsum reductions let the backend pick a shape-dependent
    reduction order: XLA:CPU vectorizes a (8, n) reduce differently from a
    (1, n) reduce, so identical per-stream values summed under different
    stream-batch shapes could differ by an ulp - which avalanches through
    the codec and breaks cross-topology archive portability. A dot is worse:
    on a GPU, XLA times several algorithms per process and keeps the fastest
    (and may run f32 in TF32), so an encoder and a decoder compiled in two
    processes could disagree. A halving tree of elementwise f32 adds pins one
    order for every shape, backend and process (zero padding is exact). It
    is used for every inexact float reduction and contraction in the
    archive-affecting path, which therefore holds no dot at all."""
    axis = axis % x.ndim
    n = x.shape[axis]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        pad = [(0, 0)] * x.ndim
        pad[axis] = (0, p - n)
        x = jnp.pad(x, pad)
    while x.shape[axis] > 1:
        h = x.shape[axis] // 2
        x = jax.lax.slice_in_dim(x, 0, h, axis=axis) + jax.lax.slice_in_dim(x, h, 2 * h, axis=axis)
    return jnp.squeeze(x, axis)


def _onehot_row(oh: jnp.ndarray, tbl: jnp.ndarray) -> jnp.ndarray:
    """(S, T) one-hot x (S, T, W) f32 table -> the selected (S, W) row, as
    an exact bit copy. The selection runs on the u32 view: a float sum would
    flush denormal bit patterns to zero on a backend that runs with
    flush-to-zero (XLA:CPU does, a GPU need not), and the steps lane of a
    mixer row holds a bitcast u32 counter, which reads as a denormal float
    below 2^23 updates."""
    bits = jax.lax.bitcast_convert_type(tbl, U32)
    sel = jnp.sum(jnp.where(oh[:, :, None], bits, U32(0)), axis=1, dtype=U32)
    return jax.lax.bitcast_convert_type(sel, F32)


def _tri_solve(Lmat: jnp.ndarray, d: jnp.ndarray) -> jnp.ndarray:
    """Solve y = d + L_strict @ y, i.e. (I - tril(L, -1)) y = d, batched.

    L[s, k, i] is mixer k's weight on earlier same-layer mixer i
    (mixer.cpp:60-64); entries with i >= k are ignored.

    A is strictly lower triangular, hence nilpotent (A^n = 0), so
    (I-A)^{-1} = (I+A)(I+A^2)(I+A^4)... exactly — log2(n) tiny batched
    products instead of an n-step sequential chain or a per-bit
    triangular-solve custom call.
    """
    n = Lmat.shape[-1]
    if n <= 1:
        return d
    A = jnp.tril(Lmat, k=-1)
    # matvecs and the A@A products as fixed-tree sums (see _tree_sum)
    y = d + _tree_sum(A * d[:, None, :])
    cover = 2  # y now includes A^0..A^(cover-1) d
    while cover < n:
        A = _tree_sum(A[:, :, :, None] * A[:, None, :, :], axis=2)
        y = y + _tree_sum(A * y[:, None, :])
        cover *= 2
    return y


def _byte_step(
    stm: Dict,
    ltm: Dict,
    coder: Dict,
    metrics: Dict,
    data_buf: jnp.ndarray,
    code_buf: jnp.ndarray,
    code_words: jnp.ndarray,
    t: jnp.ndarray,
    decode: jnp.ndarray,
    meta: Meta,
    learn: bool,
    bptt_mode: str,
    sample_u=None,
    inv_temp=None,
    bit_scan: bool = False,
    analysis: bool = True,
):
    """One byte: boundary work, 8 bit sub-steps, byte-end learn.

    All per-bit model state whose gating context is byte-stable (every
    indirect model, most mixers, the match tables) is gathered ONCE here,
    updated in registers across the 8 sub-steps via dense one-hot selects,
    and scattered back once at byte end — contiguous-row traffic instead of
    per-bit element scatters (see core/meta.py layout notes).

    bit_scan=False statically unrolls the 8 sub-steps; bit_scan=True runs
    them as a lax.scan over one shared body (~8x smaller graph, fast
    cold-cache compiles). Both instantiate the SAME sub-step code, so their
    semantics cannot diverge (default_bit_scan picks one per backend).
    """
    spec = meta.spec
    S = stm["bits_seen"].shape[0]
    s_ix = jnp.arange(S)[:, None]
    M = len(spec.indirects)
    n0, n1 = meta.mix_n0, meta.mix_n1
    K = n0 + n1 + 1
    WP = meta.mix_width_pad
    SL = meta.mix_step_lane
    nskip = len(spec.skip_connection_cols)
    lane_u = jnp.arange(256, dtype=U32)[None, None, :]
    lane_i = jnp.arange(256, dtype=I32)[None, None, :]

    # ---- byte boundary: contexts, PPM, LSTM forward ----
    stm, ltm = _boundary(stm, ltm, t, meta)
    data_byte = jax.lax.dynamic_slice_in_dim(data_buf, t, 1, axis=1)[:, 0].astype(U32)

    # ---- match byte-boundary pointer logic (match.cpp:38-58) ----
    if spec.matches:
        check_mask = U32(int(_CHECK_MASKS[0]))
        hit = stm["new_bit"][:, None] == ((stm["match_byte"] & check_mask) != 0).astype(U32)
        mlen = jnp.where(hit, jnp.minimum(stm["match_len"] + 1, 255), 0)
        mlen = jnp.where(stm["match_ptr"] == (stm["hist_n"] - U32(1))[:, None], 0, mlen)
        mcv = stm["ctx"][:, jnp.asarray(meta.match_ctx_slots)]
        match_ix = _iar(mcv & jnp.asarray(meta.match_masks)[None, :]) + jnp.asarray(
            meta.match_offsets
        )[None, :]
        tbl_ptr = ltm["match_tbl"][s_ix, match_ix]
        mptr = jnp.where(mlen < 8, tbl_ptr, stm["match_ptr"] + U32(1))
        hb = ltm["hist"][s_ix, _iar(mptr & U32(meta.history_size - 1))]
        mbyte = jnp.where((stm["hist_n"] > 0)[:, None], hb.astype(U32), stm["match_byte"])
        stm = _set(stm, match_ptr=mptr, match_byte=mbyte, match_len=mlen)

    # ---- gather the per-byte working sets (byte-stable gating contexts) ----
    ctx_byte = stm["ctx"]
    ind_ctx_vals = ctx_byte[:, jnp.asarray(meta.ind_ctx_slots)]  # (S, M)
    # indirect blocks: (ns | rm<<8) pairs, one 256-lane block per model
    blk_ix = _iar(
        ind_ctx_vals & jnp.asarray(meta.ind_blk_masks)[None, :]
    ) + jnp.asarray(meta.ind_blk_offsets)[None, :]  # (S, M)
    # hash-derived lane rotation: lane = (bit_ctx + rot) & 255 with rot taken
    # from hash bits above the block index. Two contexts colliding on a block
    # then overlap in a DERANGED lane mapping instead of lane-for-lane - the
    # block layout's equivalent of the reference's (1<<tb)*256+1 table size, whose
    # non-power-of-2 modulus breaks byte-context collision alignment
    # (indirect.cpp:15-19). Contexts narrower than 2^16 (raw byte contexts)
    # get rot=0, keeping their exact tables exact.
    ind_rot = ((ind_ctx_vals >> U32(16)) & U32(255)) * jnp.asarray(meta.ind_rotate)[None, :]  # (S, M)
    ind_blk = gather_rows(ltm["ind"]["st"], blk_ix)  # (S, M, 256) u16
    p_tbl = ltm["ind"]["p"]  # (S, 2M, 256)
    # mixer working sets by placement class (core/meta.py): gathered stable
    # rows, position blocks (one wide row each), and dense-resident small
    # tables (static slices - no scatter at all)
    Kst, Kp = len(meta.mix_st_ix), len(meta.mix_pos_ix)
    Kcd, Kpd, Klm = len(meta.mix_cd_ix), len(meta.mix_pd_ix), len(meta.mix_lm_ix)
    if Kst:
        rowix_st = _iar(
            ctx_byte[:, jnp.asarray(meta.mix_st_slots)]
            & jnp.asarray(meta.mix_st_masks)[None, :]
        ) + jnp.asarray(meta.mix_st_offsets)[None, :]
        rows_stable = gather_rows(ltm["mix_w"], rowix_st)  # (S, Kst, WP)
    else:
        rows_stable = jnp.zeros((S, 0, WP), F32)
    if Kp:
        posix = _iar(
            ctx_byte[:, jnp.asarray(meta.mix_pos_slots)]
            & jnp.asarray(meta.mix_pos_masks)[None, :]
        ) + jnp.asarray(meta.mix_pos_offsets)[None, :]
        rows_pos = gather_rows(ltm["mix_pos"], posix).reshape(S, Kp, 8, WP)
    else:
        rows_pos = jnp.zeros((S, 0, 8, WP), F32)
    dense0 = ltm["mix_dense"] if meta.mix_dense_total else None
    cd_oh = []
    rows_cd_l = []
    for i in range(Kcd):
        off, T = int(meta.mix_cd_offsets[i]), int(meta.mix_cd_sizes[i])
        val = _iar(ctx_byte[:, int(meta.mix_cd_slots[i])] & U32(T - 1))
        oh = jnp.arange(T)[None, :] == val[:, None]  # (S, T)
        cd_oh.append(oh)
        rows_cd_l.append(_onehot_row(oh, dense0[:, off : off + T]))
    rows_cd = jnp.stack(rows_cd_l, axis=1) if Kcd else jnp.zeros((S, 0, WP), F32)
    blocks_pd = (
        jnp.stack(
            [dense0[:, int(o) : int(o) + 8] for o in meta.mix_pd_offsets], axis=1
        )
        if Kpd
        else jnp.zeros((S, 0, 8, WP), F32)
    )  # (S, Kpd, 8, WP)
    lm_tbls = tuple(
        dense0[
            :,
            int(meta.mix_lm_offsets[i]) : int(meta.mix_lm_offsets[i])
            + int(meta.mix_lm_sizes[i]),
        ]
        for i in range(Klm)
    )
    max_steps = ltm["mix_max_steps"]
    # SSE/APM rows (byte-stable gating contexts; one row per stage per byte)
    if spec.apm:
        apm_ix = _iar(
            ctx_byte[:, jnp.asarray(meta.apm_ctx_slots)]
            & jnp.asarray(meta.apm_masks)[None, :]
        ) + jnp.asarray(meta.apm_offsets)[None, :]
        apm_rows0 = gather_rows(ltm["apm"], apm_ix)  # (S, NA, 8*APM_BINS)
    if spec.matches:
        mt_pred, mt_cnt = ltm["match_pred"], ltm["match_cnt"]

    # ---- coder byte-window: ONE gather per byte for the decoder's input
    # bytes, ONE scatter per byte for the encoder's renorm output; the per-bit
    # accesses work on these registers (max 32 renorm bytes + 4 lookahead per
    # byte; see _CODER_WIN) ----
    cap_total = code_buf.shape[1]
    rpos0 = coder["rpos"]
    wpos0 = coder["wpos"]
    win_lanes = U32(np.arange(_CODER_WIN))
    look = _iar(rpos0[:, None] + win_lanes[None, :])
    # decoder input window via 11 u32-WORD element gathers instead of 40
    # byte gathers (code_words is the once-per-chunk u32 view of code_buf,
    # which is read-only inside the scan)
    nwords = code_words.shape[1]
    w_ix = (rpos0 >> U32(2))[:, None] + U32(np.arange(_CODER_WIN // 4 + 1))[None, :]
    words = jnp.where(
        w_ix < nwords,
        code_words[s_ix, jnp.minimum(_iar(w_ix), nwords - 1)],
        U32(0),
    )  # (S, 11)
    off0 = (rpos0 & U32(3))[:, None]  # (S, 1)
    rel = _iar((off0 + win_lanes[None, :]) >> U32(2))  # (S, WIN) word 0..10
    shf = ((off0 + win_lanes[None, :]) & U32(3)) * U32(8)
    sel_words = jnp.sum(
        jnp.where(
            rel[:, :, None] == np.arange(_CODER_WIN // 4 + 1)[None, None, :],
            words[:, None, :],
            U32(0),
        ),
        axis=2,
    )  # (S, WIN)
    win_r = jnp.where(look < cap_total, (sel_words >> shf) & U32(255), U32(0))

    # ---- 8 bit sub-steps: ONE body, two instantiations ----
    # j is either a python int (statically unrolled, j-dependent selects
    # fold away) or a traced uint32 (lax.scan over the 8 bits — an ~8x
    # smaller HLO graph, which is what makes cold-cache CPU compiles of the
    # full byte step feasible on small hosts).
    #
    # DEFERRED TABLE WRITES: the per-bit updates of the (S, *, 256) working
    # sets (indirect blocks, state->logit tables, match tables) are NOT
    # applied per bit — that would be a full dense rewrite of those arrays
    # 8x per byte in device memory. Instead each bit records
    # (slot, delta) into an (S, *, 8) stack; reads are corrected in registers
    # against earlier same-slot deltas (for the indirect blocks not even
    # that: each bit touches a provably distinct lane, since bit_ctx values
    # of the 8 sub-steps are disjoint); the stacks are applied to the arrays
    # ONCE at byte end. EMA-style updates telescope under this scheme
    # (p + (v1-p) + (v2-v1) = v2), so the byte-end state matches the
    # sequential reference semantics up to float associativity (the rounding
    # change is container-versioned, VERSION 3).
    M2 = 2 * M
    NM = len(spec.matches)
    carry = {
        "stm": stm,
        "coder": coder,
        "metrics": metrics,
        "win_w": jnp.zeros((S, _CODER_WIN), U32),
        "bitregs": jnp.zeros((S, 4), U32),
        "rows_stable": rows_stable,
        "rows_pos": rows_pos,
        "rows_cd": rows_cd,
        "blocks_pd": blocks_pd,
        "lm_tbls": lm_tbls,
        "max_steps": max_steps,
    }
    if spec.apm:
        carry["apm_rows"] = apm_rows0
    if learn:
        # stack layout is (S, 8, width): the wide model axis stays minor
        carry["ib_lane"] = jnp.full((S, 8, M), -1, I32)
        carry["ib_del"] = jnp.zeros((S, 8, M), I32)
        carry["pt_slot"] = jnp.full((S, 8, M2), -1, I32)
        carry["pt_del"] = jnp.zeros((S, 8, M2), F32)
        if spec.matches:
            carry["mp_slot"] = jnp.full((S, 8, NM), -1, I32)
            carry["mp_del"] = jnp.zeros((S, 8, NM), F32)
            carry["mc_del"] = jnp.zeros((S, 8, NM), I32)
    ind_blk0, p_tbl0 = ind_blk, p_tbl
    if spec.matches:
        mt_pred0, mt_cnt0 = mt_pred, mt_cnt
    arange8 = jnp.arange(8, dtype=I32)

    def sub_step(carry, j):
        static_j = isinstance(j, int)
        stm, coder, metrics = carry["stm"], carry["coder"], carry["metrics"]
        win_w = carry["win_w"]
        rows_stable = carry["rows_stable"]
        rows_pos, rows_cd = carry["rows_pos"], carry["rows_cd"]
        blocks_pd, lm_tbls = carry["blocks_pd"], carry["lm_tbls"]
        max_steps = carry["max_steps"]
        j_u = U32(j) if static_j else j.astype(U32)
        j_i = I32(j) if static_j else j.astype(I32)
        # mask of sub-steps strictly before this one (register-correction term)
        prev8 = (arange8 < j_i)[None, :, None]  # (1, 8, 1) bool

        def put8(stack, col):
            """stack[:, j] = col, static or traced j."""
            if static_j:
                return stack.at[:, j].set(col.astype(stack.dtype))
            sel = arange8 == j_i
            return jnp.where(sel[None, :, None], col.astype(stack.dtype)[:, None, :], stack)

        acc = stm["acc"]
        # bits_seen counts every bit except the very first (basic-contexts.cpp:23-28);
        # it doubles as the per-mixer steps_ counter (equal by construction).
        if static_j:
            inc = jnp.where(t == 0, U32(0), U32(1)) if j == 0 else U32(1)
        else:
            inc = jnp.where((t == 0) & (j_u == 0), U32(0), U32(1))
        bits_seen = stm["bits_seen"] + inc
        bit_ctx = ((U32(1) << j_u) + acc) - U32(1)  # recent_bits - 1
        last_byte = stm["last_byte"]
        # the 4 bit-varying context values live in registers; the ctx array
        # only gets their FINAL values once per byte (checkpoint consistency)
        lb_ctx = (last_byte << U32(8)) + bit_ctx
        slb_ctx = (stm["recent"][:, 1] << U32(8)) + bit_ctx

        # ---- indirect models: dense one-hot reads of the per-byte blocks
        # (indirect.cpp:28-45); (bit_ctx + rot) & 255 selects the lane within
        # each block (rotation rationale at the blk gather above).
        # Reads come from the BYTE-START block/table snapshots: the 8 bit_ctx
        # values of one byte are disjoint, so each sub-step reads a lane no
        # earlier sub-step wrote; the state->logit table reads are corrected
        # in registers against earlier same-slot deltas (see carry comment).
        lane_sel = (bit_ctx[:, None] + ind_rot) & U32(255)  # (S, M)
        eq_lane = lane_u == lane_sel[:, :, None]  # (S, M, 256)
        pair = jnp.sum(
            jnp.where(eq_lane, ind_blk0, jnp.uint16(0)).astype(I32), axis=2
        )  # (S, M): ns | rm<<8
        ns_raw, rm_raw = pair & 255, pair >> 8
        active_ind = jnp.concatenate(
            [ns_raw != 255, rm_raw != 0], axis=1
        )  # ns: 255 = unseen; rm: 0 = unseen
        # ns state 255 (unseen) predicts/learns/advances from slot 0
        # (indirect.cpp:49-51); its prediction is masked inactive anyway.
        st_eff = jnp.concatenate([jnp.where(ns_raw == 255, 0, ns_raw), rm_raw], axis=1)
        eq_state = lane_i == st_eff[:, :, None]  # (S, 2M, 256)
        p_cur = jnp.sum(jnp.where(eq_state, p_tbl0, F32(0.0)), axis=2)
        if learn:
            same_pt = carry["pt_slot"] == st_eff[:, None, :]  # (S, 8, 2M)
            p_cur = p_cur + _tree_sum(
                jnp.moveaxis(carry["pt_del"] * (same_pt & prev8), 1, -1)
            )
        ind_preds = jnp.where(active_ind, p_cur, F32(0.0))  # (S, 2M) [ns | rm]
        # interleave to the prediction-column order [ns0, rm0, ns1, rm1, ...]
        ind_pair = jnp.stack([ind_preds[:, :M], ind_preds[:, M:]], axis=2).reshape(S, 2 * M)

        # ---- match models (match.cpp:25-74) ----
        if spec.matches:
            # j == 0's length update ran in the byte-boundary pointer logic
            if static_j:
                if j > 0:
                    check_mask = U32(int(_CHECK_MASKS[j]))
                    hit = stm["new_bit"][:, None] == (
                        (stm["match_byte"] & check_mask) != 0
                    ).astype(U32)
                    mlen = jnp.where(hit, jnp.minimum(stm["match_len"] + 1, 255), 0)
                    stm = _set(stm, match_len=mlen)
                pred_mask = U32(int(_PRED_MASKS[j]))
            else:
                check_mask = jnp.take(jnp.asarray(_CHECK_MASKS), _iar(j_u))
                hit = stm["new_bit"][:, None] == (
                    (stm["match_byte"] & check_mask) != 0
                ).astype(U32)
                mlen = jnp.where(hit, jnp.minimum(stm["match_len"] + 1, 255), 0)
                mlen = jnp.where(j_u > 0, mlen, stm["match_len"])
                stm = _set(stm, match_len=mlen)
                pred_mask = jnp.take(jnp.asarray(_PRED_MASKS), _iar(j_u))
            mlen = stm["match_len"]
            mbyte = stm["match_byte"]
            active = mlen > 2
            eq_len = lane_i == mlen[:, :, None]  # (S, NM, 256)
            mp = jnp.sum(jnp.where(eq_len, mt_pred0, F32(0.0)), axis=2)
            if learn:
                same_mp = carry["mp_slot"] == _iar(mlen)[:, None, :]  # (S, 8, NM)
                mp = mp + _tree_sum(
                    jnp.moveaxis(carry["mp_del"] * (same_mp & prev8), 1, -1)
                )
            p_prob = jnp.where((mbyte & pred_mask) != 0, mp, F32(1.0) - mp)
            match_preds = jnp.where(active, logit(p_prob), F32(0.0))
            longest = jnp.max((mlen // 32).astype(U32), axis=1)  # match.cpp:71-73
        else:
            match_preds = jnp.zeros((S, 0), F32)
            longest = jnp.zeros((S,), U32)

        # ---- PPM + LSTM bit predictions (interval narrowing) ----
        first = (j == 0) if static_j else (j_u == 0)
        head = []
        if spec.ppm is not None:
            lg, ptop, pbot, pmid = _interval_bit_pred(
                stm["ppm_probs"], stm["ppm_top"], stm["ppm_bot"], stm["ppm_mid"],
                stm["new_bit"], first,
            )
            head.append(lg[:, None])
            stm = _set(stm, ppm_top=ptop, ppm_bot=pbot, ppm_mid=pmid)
        if spec.lstm is not None:
            lst = stm["lstm"]
            lg, top, bot, mid = _interval_bit_pred(
                lst["probs"], lst["top"], lst["bot"], lst["mid"], stm["new_bit"], first
            )
            head.append(lg[:, None])
            stm = _set(stm, lstm=_set(lst, top=top, bot=bot, mid=mid))

        # prediction vector, column order [ppm?, lstm?, ind pairs..., matches...]
        preds = jnp.concatenate(head + [ind_pair, match_preds], axis=1)

        # ---- mixers (mixer.cpp:51-106): every class's working rows come
        # from the per-byte register carries (no per-bit HBM row movement);
        # nilpotent-doubling solves for the in-layer chains, then the final
        # unit ----
        stm = _set(stm, bits_seen=bits_seen)
        bitregs = jnp.stack([bit_ctx, lb_ctx, slb_ctx, longest], axis=1)  # (S, 4)
        skip_preds = (
            preds[:, jnp.asarray(np.array(spec.skip_connection_cols, np.int32))]
            if nskip
            else jnp.zeros((S, 0), F32)
        )
        # assemble the K weight rows in k-order from the class carries
        parts = [rows_stable]
        if Kp:
            parts.append(
                rows_pos[:, :, j]
                if static_j
                else jax.lax.dynamic_index_in_dim(rows_pos, j_i, 2, keepdims=False)
            )
        parts.append(rows_cd)
        if Kpd:
            parts.append(
                blocks_pd[:, :, j]
                if static_j
                else jax.lax.dynamic_index_in_dim(blocks_pd, j_i, 2, keepdims=False)
            )
        lm_ohs = []
        if Klm:
            lm_rows = []
            for i in range(Klm):
                T = lm_tbls[i].shape[1]
                oh = jnp.arange(T)[None, :] == _iar(longest)[:, None]  # (S, T)
                lm_ohs.append(oh)
                lm_rows.append(_onehot_row(oh, lm_tbls[i]))
            parts.append(jnp.stack(lm_rows, axis=1))
        rows = jnp.concatenate(parts, axis=1)[:, jnp.asarray(meta.mix_perm)]
        stepv = jax.lax.bitcast_convert_type(rows[:, :, SL], U32)  # (S, K)
        # forward view with the bitcast steps lane zeroed: once a counter's bit
        # pattern reaches 0x7F800000 (~2.1e9 updates) the lane reads as inf/NaN
        # and inf*0 in the mixer products would NaN-poison every prediction.
        # (a lane-mask SELECT, not .at[...].set: a dynamic-update-slice here
        # can materialize a full (S, K, WP) copy per sub-step. A
        # multiply-by-zero would instead propagate the NaN the zeroing exists
        # to suppress.)
        sl_is = (jnp.arange(WP) == SL)[None, None, :]
        rows_f = jnp.where(sl_is, F32(0.0), rows)

        # bit-prefix input features (spec.prefix_inputs): +-1 for the byte's
        # bits seen so far, 0 for unseen positions - the linear-input form of
        # the prefix information that position-gated mixers dropped from
        # their gates (config.MixerModel.pos). The features ride the base
        # concatenations directly (a dynamic-update-slice would copy the
        # whole base per sub-step).
        if meta.prefix_lane0 >= 0:
            i8 = jnp.arange(8, dtype=I32)[None, :]
            sh = jnp.clip(j_i - 1 - i8, 0, 31).astype(U32)
            bits8 = (acc[:, None] >> sh) & U32(1)
            pfx = jnp.where(
                i8 < j_i, F32(2.0) * bits8.astype(F32) - F32(1.0), F32(0.0)
            )  # (S, 8)
            npf = 8
        else:
            pfx = jnp.zeros((S, 0), F32)
            npf = 0

        base0 = jnp.concatenate(
            [preds, jnp.zeros((S, n0), F32), pfx,
             jnp.zeros((S, WP - meta.n_pred - n0 - npf), F32)], axis=1
        )
        d0 = _tree_sum(rows_f[:, :n0] * base0[:, None, :])
        y0 = _tri_solve(rows_f[:, :n0, meta.n_pred : meta.n_pred + n0], d0) if n0 > 1 else d0

        base1 = jnp.concatenate(
            [y0, jnp.zeros((S, n1), F32), skip_preds, pfx,
             jnp.zeros((S, WP - n0 - n1 - nskip - npf), F32)], axis=1
        )
        d1 = _tree_sum(rows_f[:, n0 : n0 + n1] * base1[:, None, :])
        y1 = _tri_solve(rows_f[:, n0 : n0 + n1, n0 : n0 + n1], d1) if n1 > 1 else d1

        base2 = jnp.concatenate(
            [y0, y1, skip_preds, pfx,
             jnp.zeros((S, WP - n0 - n1 - nskip - npf), F32)], axis=1
        )
        final_logit = _tree_sum(rows_f[:, K - 1] * base2)
        prob = clamp_prob(logistic(final_logit))

        # ---- SSE/APM refinement chain (config.ApmStage): interpolated
        # table lookup of the quantized probability, per bit position; the
        # coder consumes the refined probability. Learn happens after the
        # bit is known (below). ----
        NA = len(spec.apm)
        if NA:
            apm_rows = carry["apm_rows"]
            nb_lane = jnp.arange(APM_BINS, dtype=I32)[None, :]
            apm_slices, apm_wvs, apm_pvs = [], [], []
            apm_l, apm_p = final_logit, prob
            for a in range(NA):
                if static_j:
                    row = apm_rows[:, a, j * APM_BINS : (j + 1) * APM_BINS]
                else:
                    row = jax.lax.dynamic_slice_in_dim(
                        apm_rows[:, a], j_i * APM_BINS, APM_BINS, axis=1
                    )
                pos = (jnp.clip(apm_l, -APM_SPAN, APM_SPAN) + APM_SPAN) * F32(
                    (APM_BINS - 1) / (2 * APM_SPAN)
                )
                i0 = jnp.minimum(pos.astype(I32), APM_BINS - 2)
                w = pos - i0.astype(F32)
                wv = jnp.where(
                    nb_lane == i0[:, None], F32(1.0) - w[:, None], F32(0.0)
                ) + jnp.where(nb_lane == i0[:, None] + 1, w[:, None], F32(0.0))
                pv = jnp.sum(row * wv, axis=1)
                wgt = F32(float(meta.apm_weights[a]))
                apm_p = clamp_prob(wgt * pv + (F32(1.0) - wgt) * apm_p)
                apm_l = logit(apm_p)
                apm_slices.append(row)
                apm_wvs.append(wv)
                apm_pvs.append(pv)
            prob = apm_p

        # ---- arithmetic coder (encoder.cpp:10-25 / decoder.cpp:19-39) ----
        if sample_u is None:
            enc_bit = (data_byte >> (U32(7) - j_u)) & U32(1)
        else:
            # temperature sampling (runner-utils.cpp:202-206)
            p_temp = logistic(logit(prob) * inv_temp)
            u_j = sample_u[j] if static_j else (
                jax.lax.dynamic_index_in_dim(sample_u, _iar(j_u), 0, keepdims=False)
            )
            enc_bit = (u_j < p_temp).astype(U32)
        # per-bit coder IO works on the byte-window registers (win_r read-only
        # closure, win_w carried); code_buf itself is touched once per byte
        rpos = coder["rpos"]
        k4 = U32(np.arange(4))[None, :]
        off_r = (rpos - rpos0)[:, None] + k4  # (S, 4) lane offsets, < _CODER_WIN
        sel_r = off_r[:, :, None] == win_lanes[None, None, :]  # (S, 4, WIN)
        in_bytes = jnp.sum(jnp.where(sel_r, win_r[:, None, :], U32(0)), axis=2)
        cst = coder_ops.CoderState(coder["x1"], coder["x2"], coder["x"])
        bit, cst, emits, nrenorm = coder_ops.coder_bit(
            cst, coder_ops.discretize(prob), enc_bit, in_bytes, decode
        )
        # encoder accumulates renorm bytes into the window; decoder only
        # advances its read cursor. Each window lane is written at most once
        # per byte (wpos strictly advances), so add-accumulate is exact.
        wpos = coder["wpos"]
        valid = (k4 < nrenorm.astype(U32)[:, None]) & jnp.logical_not(decode)
        off_w = (wpos - wpos0)[:, None] + k4
        sel_w = off_w[:, :, None] == win_lanes[None, None, :]
        win_w = win_w + jnp.sum(
            jnp.where(sel_w & valid[:, :, None], emits[:, :, None], U32(0)), axis=1
        )
        coder = {
            "x1": cst.x1,
            "x2": cst.x2,
            "x": cst.x,
            "wpos": wpos + jnp.where(decode, U32(0), nrenorm.astype(U32)),
            "rpos": rpos + jnp.where(decode, nrenorm.astype(U32), U32(0)),
        }

        # cumulative cross-entropy metric (bits) (runner.cpp:96-101)
        p_bit = jnp.where(bit == 1, prob, F32(1.0) - prob)
        metrics = _set(metrics, ent=metrics["ent"] - jnp.log2(p_bit))
        # per-column analysis EMA over model predictions, L0/L1 mixer outputs
        # and the final output (UpdateEntropy alpha=1e-5, predictor.cpp:439-469;
        # the reference clamps the METRIC's probability at eps=0.01, :458-462 -
        # matched here so EMAs are directly comparable to its entropy.tsv).
        # analysis=False traces a program without the EMA ops entirely, like
        # the reference's per-model enable_analysis flags (predictor.cpp:124).
        if analysis:
            col_logits = jnp.concatenate([preds, y0, y1, final_logit[:, None]], axis=1)
            p_cols = jnp.clip(logistic(col_logits), F32(0.01), F32(0.99))
            pb_cols = jnp.where((bit == 1)[:, None], p_cols, F32(1.0) - p_cols)
            metrics = _set(
                metrics,
                ema=metrics["ema"] + F32(1e-5) * (-jnp.log2(pb_cols) - metrics["ema"]),
            )

        bitf = bit.astype(F32)
        cur_byte = (acc << U32(1)) | bit  # completed byte value at j == 7

        if learn and NA:
            # APM learn: move the two interpolation bins toward the bit,
            # in-register (rows scatter once per byte at byte end)
            for a in range(NA):
                new_row = apm_slices[a] + F32(float(meta.apm_lrs[a])) * (
                    bitf - apm_pvs[a]
                )[:, None] * apm_wvs[a]
                if static_j:
                    apm_rows = apm_rows.at[
                        :, a, j * APM_BINS : (j + 1) * APM_BINS
                    ].set(new_row)
                else:
                    apm_rows = jax.lax.dynamic_update_slice(
                        apm_rows, new_row[:, None, :], (0, a, j_i * APM_BINS)
                    )
            carry = _set(carry, apm_rows=apm_rows)

        if learn:
            # indirect Learn (indirect.cpp:47-70): record the state->logit
            # delta and the advanced state-pair into the byte stacks
            delta = (bitf[:, None] - logistic(p_cur)) * jnp.asarray(meta.ind_lrs)[None, :]
            # state advance: ns half via the nonstationary table, rm half via
            # the run-map table (256x2 next tables). The lookup rides the
            # ALREADY-COMPUTED one-hot eq_state as a vectorized lane
            # reduction instead of a jnp.take with (S, M) indices.
            ns0 = jnp.asarray(_NS_NEXT[0::2], I32)[None, None, :]  # next on bit 0
            ns1 = jnp.asarray(_NS_NEXT[1::2], I32)[None, None, :]
            rm0 = jnp.asarray(_RM_NEXT[0::2], I32)[None, None, :]
            rm1 = jnp.asarray(_RM_NEXT[1::2], I32)[None, None, :]
            bsel = (bit == 1)[:, None, None]
            ns_nx = jnp.where(bsel, ns1, ns0)  # (S, 1, 256)
            rm_nx = jnp.where(bsel, rm1, rm0)
            new_ns = jnp.sum(jnp.where(eq_state[:, :M], ns_nx, 0), axis=2)
            new_rm = jnp.sum(jnp.where(eq_state[:, M:], rm_nx, 0), axis=2)
            new_pair = new_ns | (new_rm << 8)  # (S, M) i32
            carry = _set(
                carry,
                ib_lane=put8(carry["ib_lane"], _iar(lane_sel)),
                ib_del=put8(carry["ib_del"], new_pair - pair),
                pt_slot=put8(carry["pt_slot"], st_eff),
                pt_del=put8(carry["pt_del"], delta),
            )

            # match per-bit Learn (match.cpp:79-90)
            if spec.matches:
                hit2 = (bit[:, None] == ((mbyte & pred_mask) != 0).astype(U32)).astype(F32)
                cnt = jnp.sum(jnp.where(eq_len, mt_cnt0, 0), axis=2)
                cnt = cnt + jnp.sum(carry["mc_del"] * (same_mp & prev8), axis=1)
                limits = jnp.asarray(meta.match_limits)[None, :]
                grow = cnt < limits
                cnt_new = jnp.where(grow, cnt + 1, cnt)
                lr = F32(1.0) / jnp.where(grow, cnt_new, limits).astype(F32)
                mp_new = mp + (hit2 - mp) * lr
                upd_on = mlen > 2  # only matched rows learn (match.cpp:79)
                carry = _set(
                    carry,
                    mp_slot=put8(carry["mp_slot"], _iar(mlen)),
                    mp_del=put8(carry["mp_del"], jnp.where(upd_on, mp_new - mp, F32(0.0))),
                    mc_del=put8(
                        carry["mc_del"], jnp.where(upd_on & grow, 1, 0)
                    ),
                )

            # mixer Learn (mixer.cpp:108-176): in-register row updates;
            # only the bit-varying rows scatter per sub-step
            steps_f = bits_seen.astype(F32)
            decay_global = F32(0.9) / pow_det(F32(1e-7) * steps_f + F32(0.8), 0.8)
            y_all = jnp.concatenate([y0, y1, final_logit[:, None]], axis=1)  # (S, K)
            novelty = F32(1.5) - stepv.astype(F32) / max_steps.astype(F32)
            upd = (
                decay_global[:, None] * novelty * jnp.asarray(meta.mix_lrs)[None, :]
                * (logistic(y_all) - bitf[:, None])
            )  # (S, K)
            # input matrix: per-layer base + strictly-lower in-layer part
            tril0 = jnp.tril(jnp.ones((n0, n0), F32), k=-1)
            in0 = jnp.broadcast_to(base0[:, None, :], (S, n0, WP))
            in0 = in0.at[:, :, meta.n_pred : meta.n_pred + n0].set(y0[:, None, :] * tril0[None])
            tril1 = jnp.tril(jnp.ones((n1, n1), F32), k=-1)
            in1 = jnp.broadcast_to(base1[:, None, :], (S, n1, WP))
            in1 = in1.at[:, :, n0 : n0 + n1].set(y1[:, None, :] * tril1[None])
            inputs = jnp.concatenate([in0, in1, base2[:, None, :]], axis=1)  # (S, K, WP)
            # inputs is 0 in the steps lane, so the SGD step preserves it;
            # the weight-decay multiply does not, so the lane is rewritten
            # with the incremented bitcast counter afterwards.
            w_new = rows - upd[:, :, None] * inputs
            steps_new = stepv + U32(1)
            wd = (steps_new & U32(1023)) == 0  # weight decay every 1024 context-steps
            w_new = w_new * jnp.where(wd, F32(1.0) - F32(3e-6), F32(1.0))[:, :, None]
            # steps lane via lane-mask select (no dynamic-update-slice copy)
            w_new = jnp.where(
                sl_is, jax.lax.bitcast_convert_type(steps_new, F32)[:, :, None], w_new
            )
            # route the updated rows back into their class carries (all
            # register-resident; HBM write-back happens once at byte end)
            rows_stable = w_new[:, jnp.asarray(meta.mix_st_ix)]
            if Kp:
                wp_new = w_new[:, jnp.asarray(meta.mix_pos_ix)]  # (S, Kp, WP)
                if static_j:
                    rows_pos = rows_pos.at[:, :, j].set(wp_new)
                else:
                    rows_pos = jnp.where(
                        (arange8 == j_i)[None, None, :, None],
                        wp_new[:, :, None, :],
                        rows_pos,
                    )
            if Kcd:
                rows_cd = w_new[:, jnp.asarray(meta.mix_cd_ix)]
            if Kpd:
                pd_new = w_new[:, jnp.asarray(meta.mix_pd_ix)]
                if static_j:
                    blocks_pd = blocks_pd.at[:, :, j].set(pd_new)
                else:
                    blocks_pd = jnp.where(
                        (arange8 == j_i)[None, None, :, None],
                        pd_new[:, :, None, :],
                        blocks_pd,
                    )
            if Klm:
                lm_tbls = tuple(
                    jnp.where(
                        lm_ohs[i][:, :, None],
                        w_new[:, int(meta.mix_lm_ix[i])][:, None, :],
                        lm_tbls[i],
                    )
                    for i in range(Klm)
                )
            max_steps = jnp.maximum(max_steps, steps_new)

        # advance bit registers
        stm = _set(stm, new_bit=bit, acc=(acc << U32(1)) | bit)

        return _set(
            carry,
            stm=stm,
            coder=coder,
            metrics=metrics,
            win_w=win_w,
            bitregs=bitregs,
            rows_stable=rows_stable,
            rows_pos=rows_pos,
            rows_cd=rows_cd,
            blocks_pd=blocks_pd,
            lm_tbls=lm_tbls,
            max_steps=max_steps,
        )

    if bit_scan:
        carry, _ = jax.lax.scan(
            lambda c, jj: (sub_step(c, jj), None),
            carry,
            jnp.arange(8, dtype=U32),
        )
    else:
        for j in range(8):
            carry = sub_step(carry, j)
    stm, coder, metrics = carry["stm"], carry["coder"], carry["metrics"]
    rows_stable = carry["rows_stable"]
    rows_pos, rows_cd = carry["rows_pos"], carry["rows_cd"]
    blocks_pd, lm_tbls = carry["blocks_pd"], carry["lm_tbls"]
    max_steps = carry["max_steps"]
    cur_byte = stm["acc"]  # all 8 bits accumulated = the completed byte
    bitregs = carry["bitregs"]
    longest = bitregs[:, 3]
    if spec.apm and learn:
        apm_rows_final = carry["apm_rows"]
    win_w_final = carry["win_w"]

    # ---- apply the deferred per-bit table writes: ONE dense pass per
    # array per byte instead of 8 (see the carry comment above); the
    # j-sum fuses into a single elementwise kernel over each (S, *, 256)
    # array ----
    if learn:
        ib = ind_blk.astype(I32)
        pt = p_tbl
        for jj in range(8):
            ib = ib + carry["ib_del"][:, jj, :, None] * (
                lane_i == carry["ib_lane"][:, jj, :, None]
            )
            pt = pt + carry["pt_del"][:, jj, :, None] * (
                lane_i == carry["pt_slot"][:, jj, :, None]
            )
        ind_blk = ib.astype(jnp.uint16)
        p_tbl = pt
        if spec.matches:
            mtp, mtc = mt_pred, mt_cnt
            for jj in range(8):
                eq = lane_i == carry["mp_slot"][:, jj, :, None]
                mtp = mtp + carry["mp_del"][:, jj, :, None] * eq
                mtc = mtc + carry["mc_del"][:, jj, :, None] * eq
            mt_pred, mt_cnt = mtp, mtc

    # ---- coder window emit: the renorm bytes of this input byte leave the
    # program as scan OUTPUTS (a dense per-byte write) instead of an (S, 40)
    # element scatter into code_buf. The host assembles the byte stream from
    # (win, nw) per byte (codec.run_chunks); encode can no longer overflow a
    # device buffer, so the old sticky-overflow flag is gone. Decode emits
    # zeros (ignored). ----
    nwritten = coder["wpos"] - wpos0  # (S,)
    win_out = win_w_final.astype(jnp.uint8)  # (S, _CODER_WIN)
    nw_out = nwritten.astype(jnp.uint8)

    # ---- final per-bit context values -> ctx array (checkpoint consistency:
    # the serialized ctx at a byte boundary equals what the last sub-step saw)
    stm = _set(
        stm,
        ctx=stm["ctx"].at[:, jnp.asarray(meta.bitreg_ctx_cols)].set(bitregs),
    )

    # ---- byte end: scatter the per-byte working sets back, history append,
    # match pointer write, LSTM perceive ----
    if learn:
        ltm = _set(
            ltm,
            ind={
                "st": scatter_rows(ltm["ind"]["st"], blk_ix, ind_blk),
                "p": p_tbl,
            },
            mix_max_steps=max_steps,
        )
        if Kst:
            ltm = _set(ltm, mix_w=scatter_rows(ltm["mix_w"], rowix_st, rows_stable))
        if Kp:
            ltm = _set(
                ltm,
                mix_pos=scatter_rows(
                    ltm["mix_pos"], posix, rows_pos.reshape(S, Kp, 8 * WP)
                ),
            )
        if meta.mix_dense_total:
            # dense arena write-back: static slices + one-hot selects only -
            # no scatter (the whole pass fuses into one elementwise kernel)
            dense_new = dense0
            for i in range(Kcd):
                off, T = int(meta.mix_cd_offsets[i]), int(meta.mix_cd_sizes[i])
                cur = dense_new[:, off : off + T]
                dense_new = dense_new.at[:, off : off + T].set(
                    jnp.where(cd_oh[i][:, :, None], rows_cd[:, i][:, None, :], cur)
                )
            for i in range(Kpd):
                off = int(meta.mix_pd_offsets[i])
                dense_new = dense_new.at[:, off : off + 8].set(blocks_pd[:, i])
            for i in range(Klm):
                off, T = int(meta.mix_lm_offsets[i]), int(meta.mix_lm_sizes[i])
                dense_new = dense_new.at[:, off : off + T].set(lm_tbls[i])
            ltm = _set(ltm, mix_dense=dense_new)
        if spec.matches:
            ltm = _set(ltm, match_pred=mt_pred, match_cnt=mt_cnt)
        if spec.apm:
            ltm = _set(ltm, apm=scatter_rows(ltm["apm"], apm_ix, apm_rows_final))
        hist_n = stm["hist_n"]
        append = longest < 2
        hpos = jnp.where(append, hist_n & U32(meta.history_size - 1), U32(meta.history_size))
        ltm = _set(
            ltm,
            hist=ltm["hist"].at[s_ix[:, 0], _iar(hpos)].set(
                cur_byte.astype(ltm["hist"].dtype), mode="drop"
            ),
        )
        hist_n = hist_n + append.astype(U32)
        stm = _set(stm, hist_n=hist_n)
        if spec.matches:
            # match.cpp:92-108: tables skip updates on long matches
            newp = hist_n - U32(1)  # position of the just-appended byte
            old = ltm["match_tbl"][s_ix, match_ix]
            val = jnp.where(append[:, None], jnp.broadcast_to(newp[:, None], match_ix.shape), old)
            ltm = _set(
                ltm,
                match_tbl=ltm["match_tbl"].at[s_ix, match_ix].set(val, unique_indices=True),
            )
        if spec.lstm is not None:
            stm, ltm = _lstm_perceive(stm, ltm, _iar(cur_byte), meta, bptt_mode)

    # write the reconstructed byte (decode reconstructs; encode rewrites the
    # identical value - one unified program)
    data_buf = jax.lax.dynamic_update_slice_in_dim(
        data_buf, cur_byte.astype(data_buf.dtype)[:, None], t, axis=1
    )
    return stm, ltm, coder, metrics, data_buf, code_buf, win_out, nw_out


# ---------------------------------------------------------------------------
# chunk scans
# ---------------------------------------------------------------------------


def _code_words(code_buf: jnp.ndarray) -> jnp.ndarray:
    """Once-per-chunk u32-word view of the (read-only inside the scan) code
    buffer, for the decoder's word-granular window gather."""
    S, cap = code_buf.shape
    pad = (-cap) % 4
    if pad:
        code_buf = jnp.pad(code_buf, ((0, 0), (0, pad)))
    b = code_buf.reshape(S, -1, 4).astype(jnp.uint32)
    # little-endian byte order: byte k of word w is bits 8k
    return (b[:, :, 0] | (b[:, :, 1] << 8) | (b[:, :, 2] << 16)
            | (b[:, :, 3] << 24))


def make_chunk_fn_raw(meta: Meta, chunk: int, learn: bool = True, bit_scan: bool = False,
                      analysis: bool = True):
    """Build the UNJITTED chunk processor (for shard_map wrapping — see
    gmix_tpu.parallel.mesh.make_sharded_chunk_fn; XLA's SPMD partitioner
    silently drops the batched row scatters when the jitted fn is fed
    stream-sharded arrays directly, so multi-device execution must run the
    per-shard program on local shapes instead).

    fn(state, data_buf, code_buf, t0, decode) ->
    (state, data_buf, code_buf, win, nw) processes `chunk` bytes starting at
    byte offset t0; win (chunk, S, 40) u8 / nw (chunk, S) u8 are the encoder's
    renorm bytes per input byte (scan outputs; the host assembles the code
    stream from them — see codec.run_chunks). Decode emits zeros. With learning on and
    an LSTM whose horizon divides the chunk, the scan nests as
    [segments x horizon] and BPTT runs unconditionally at segment ends
    (callers must then keep t0 horizon-aligned, which chunk-multiple t0
    guarantees); otherwise BPTT sits behind a lax.cond.
    """
    spec = meta.spec
    Hz = spec.lstm.horizon if spec.lstm is not None else 0
    seg_aligned = learn and Hz > 0 and chunk % Hz == 0
    bptt_mode = "defer" if seg_aligned else "cond"

    def byte_scan_step(carry, t):
        state, data_buf, code_buf, code_words, decode = carry
        stm, ltm, coder, metrics = (
            state["stm"], state["ltm"], state["coder"], state["metrics"],
        )
        stm, ltm, coder, metrics, data_buf, code_buf, win, nw = _byte_step(
            stm, ltm, coder, metrics, data_buf, code_buf, code_words, t, decode,
            meta, learn, bptt_mode, bit_scan=bit_scan, analysis=analysis,
        )
        return (
            {"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics},
            data_buf,
            code_buf,
            code_words,
            decode,
        ), (win, nw)

    if seg_aligned:

        def seg_step(carry, s0):
            carry, ys = jax.lax.scan(byte_scan_step, carry, s0 + jnp.arange(Hz, dtype=I32))
            state = carry[0]
            # epoch wrapped exactly now; run the deferred BPTT unconditionally
            lst, lw = _lstm_bptt(state["stm"]["lstm"], state["ltm"]["lstm"], meta)
            state = _set(
                state,
                stm=_set(state["stm"], lstm=lst),
                ltm=_set(state["ltm"], lstm=lw),
            )
            return ((state,) + carry[1:]), ys

        def chunk_fn(state, data_buf, code_buf, t0, decode):
            carry = (state, data_buf, code_buf, _code_words(code_buf), decode)
            starts = t0.astype(I32) + jnp.arange(0, chunk, Hz, dtype=I32)
            carry, (win, nw) = jax.lax.scan(seg_step, carry, starts)
            win = win.reshape((chunk,) + win.shape[2:])
            nw = nw.reshape((chunk,) + nw.shape[2:])
            return carry[0], carry[1], carry[2], win, nw

    else:

        def chunk_fn(state, data_buf, code_buf, t0, decode):
            carry = (state, data_buf, code_buf, _code_words(code_buf), decode)
            ts = t0.astype(I32) + jnp.arange(chunk, dtype=I32)
            carry, (win, nw) = jax.lax.scan(byte_scan_step, carry, ts)
            return carry[0], carry[1], carry[2], win, nw

    return chunk_fn


def make_chunk_fn(meta: Meta, chunk: int, learn: bool = True, bit_scan: bool = False,
                  analysis: bool = True):
    """Jitted single-host chunk processor (see make_chunk_fn_raw)."""
    return jax.jit(
        make_chunk_fn_raw(meta, chunk, learn, bit_scan, analysis),
        donate_argnums=(0, 1, 2),
    )


def make_gen_chunk_fn_raw(meta: Meta, chunk: int, bit_scan: bool = False):
    """UNJITTED generation chunk: temperature sampling with NO learn code in
    the program at all (runner-utils.cpp:196-215).
    fn(state, data_buf, t0, u, inv_temp) -> (state, data_buf);
    u is (chunk*8, S) uniforms."""

    def byte_scan_step(carry, xs):
        t, u = xs  # u: (8, S)
        state, data_buf, code_buf, inv_temp = carry
        stm, ltm, coder, metrics = (
            state["stm"], state["ltm"], state["coder"], state["metrics"],
        )
        stm, ltm, coder, metrics, data_buf, code_buf, _win, _nw = _byte_step(
            stm, ltm, coder, metrics, data_buf, code_buf,
            jnp.zeros((data_buf.shape[0], 2), jnp.uint32), t,
            jnp.asarray(False), meta, False, "cond",
            sample_u=u, inv_temp=inv_temp, bit_scan=bit_scan,
        )
        return (
            {"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics},
            data_buf,
            code_buf,
            inv_temp,
        ), ()

    def gen_fn(state, data_buf, t0, u, inv_temp):
        S = data_buf.shape[0]
        code_buf = jnp.zeros((S, 8), jnp.uint8)  # sink; all writes dropped
        ts = t0.astype(I32) + jnp.arange(chunk, dtype=I32)
        u = u.reshape(chunk, 8, S)
        carry = (state, data_buf, code_buf, inv_temp)
        carry, _ = jax.lax.scan(byte_scan_step, carry, (ts, u))
        return carry[0], carry[1]

    return gen_fn


def make_gen_chunk_fn(meta: Meta, chunk: int, bit_scan: bool = False):
    return jax.jit(make_gen_chunk_fn_raw(meta, chunk, bit_scan), donate_argnums=(0, 1))


def default_bit_scan() -> bool:
    """Scanned sub-steps on the CPU (the ~8x smaller graph keeps cold-cache
    compiles of the tests tractable), unrolled on an accelerator. On an H100
    (best profile, 4 streams, chunk 1000) the unrolled form ran at 1657
    us/byte against 2093 for the scanned one, for 94 s of compile against
    33 s."""
    return jax.default_backend() == "cpu"


@functools.lru_cache(maxsize=64)
def get_chunk_fn(spec: EnsembleSpec, chunk: int, learn: bool = True, analysis: bool = True):
    """Process-wide compile cache: one jitted chunk program per (spec, chunk)."""
    from .meta import build_meta

    return make_chunk_fn(build_meta(spec), chunk, learn, bit_scan=default_bit_scan(),
                         analysis=analysis)


@functools.lru_cache(maxsize=16)
def get_gen_chunk_fn(spec: EnsembleSpec, chunk: int):
    from .meta import build_meta

    return make_gen_chunk_fn(build_meta(spec), chunk, bit_scan=default_bit_scan())
