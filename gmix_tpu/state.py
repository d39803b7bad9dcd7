"""Codec state as a pytree of batched arrays.

The reference's ShortTermMemory / LongTermMemory object graphs
(src/memory/short-term-memory.h, long-term-memory.h) become one nested dict of
arrays with a leading stream axis S. Every array is functionally updated inside
the scan; checkpointing, copying, and multi-device sharding all fall out of the
pytree structure (SURVEY.md 7, design point 1).

Lazy allocations in the reference (mixer rows, state tables) become dense
zero/sentinel-initialised arrays with identical semantics: an unseen mixer
context has all-zero weights and therefore outputs 0 exactly like a missing
MixerData (mixer.cpp:53-55); unseen indirect contexts hold the sentinel states
255/0 (long-term-memory.h:11-16).
"""
from __future__ import annotations

import math
from typing import Dict

import jax
import jax.numpy as jnp
import numpy as np

from .core.meta import Meta

DEFAULT_SEED = 0xDEADBEEF


def init_state(meta: Meta, num_streams: int, seed: int = DEFAULT_SEED) -> Dict:
    spec = meta.spec
    S = num_streams
    f32, u32, i32, u8 = jnp.float32, jnp.uint32, jnp.int32, jnp.uint8

    stm: Dict = {
        "bits_seen": jnp.zeros((S,), u32),
        "new_bit": jnp.zeros((S,), u32),
        "acc": jnp.zeros((S,), u32),  # bits of the in-flight byte (MSB-first value)
        "last_byte": jnp.zeros((S,), u32),
        # recent[:, i] = byte i-ago (i=0: last); sized to the deepest roll ctx
        "recent": jnp.zeros((S, meta.recent_size), u32),
        "ctx": jnp.zeros((S, meta.n_ctx), u32),
        "hist_n": jnp.zeros((S,), u32),
        "ppm_probs": jnp.full((S, 256), 1.0 / 256, f32),
    }
    if spec.roll_ctxs:
        stm["roll_h"] = jnp.zeros((S, len(spec.roll_ctxs)), u32)
    if spec.matches:
        nm = len(spec.matches)
        stm["match_ptr"] = jnp.zeros((S, nm), u32)
        stm["match_byte"] = jnp.zeros((S, nm), u32)
        stm["match_len"] = jnp.zeros((S, nm), i32)
    if spec.ihash_ctxs:
        nih = len(spec.ihash_ctxs)
        stm["ih_outer_ctx"] = jnp.zeros((S, nih), u32)
        stm["ih_outer_hash"] = jnp.zeros((S, nih), u32)

    ltm: Dict = {}

    # --- indirect models: ONE block arena of (ns | rm<<8) uint16 pairs (ns
    # init 255 = never seen, rm init 0 -> word 0x00FF; long-term-memory.h:11-16)
    # and the shared 256-entry state->logit tables (rows [ns models | rm
    # models]). Block layout rationale in core/meta.py.
    M = len(spec.indirects)
    ltm["ind"] = {
        "st": jnp.full((S, meta.ind_nblocks, 256), 255, jnp.uint16),
        "p": jnp.zeros((S, 2 * M, 256), f32),
    }

    # --- mixers: three arenas by placement class (core/meta.py): gathered
    # stable rows, (8, WP) position blocks, and the dense-resident small
    # tables. Per-row steps counters live bitcast into lane
    # meta.mix_step_lane (zero-init f32 == zero-init u32). ---
    K = meta.mix_n0 + meta.mix_n1 + 1
    WP = meta.mix_width_pad
    if meta.mix_total_rows:
        ltm["mix_w"] = jnp.zeros((S, meta.mix_total_rows, WP), f32)
    if meta.mix_pos_groups:
        # FLAT wide rows (8*WP lanes): gathered/scattered as-is; reshaping a
        # (G, 8, WP) arena to (G, 8*WP) per byte could relayout-copy the
        # whole arena every byte
        ltm["mix_pos"] = jnp.zeros((S, meta.mix_pos_groups, 8 * WP), f32)
    if meta.mix_dense_total:
        ltm["mix_dense"] = jnp.zeros((S, meta.mix_dense_total, WP), f32)
    ltm["mix_max_steps"] = jnp.ones((S, K), u32)  # mixer.cpp:8

    # --- match models ---
    if spec.matches:
        nm = len(spec.matches)
        ltm["match_tbl"] = jnp.zeros((S, meta.match_total), u32)
        # predictions[i] = 0.5 + (i+0.5)/512, counts = 1 (match.cpp:19-23)
        pred0 = 0.5 + (np.arange(256, dtype=np.float32) + 0.5) / 512.0
        ltm["match_pred"] = jnp.broadcast_to(jnp.asarray(pred0, f32), (S, nm, 256)).copy()
        ltm["match_cnt"] = jnp.ones((S, nm, 256), i32)

    # --- indirect-hash tables: model-member state, serialized short-term in
    # the reference (indirect-hash.cpp:33-54 via predictor.cpp:396-399) and
    # still updating during generation ---
    if spec.ihash_ctxs:
        stm["ih_tbl"] = jnp.zeros((S, meta.ih_total), u32)

    # --- dedup history ring ---
    ltm["hist"] = jnp.zeros((S, meta.history_size), u8)

    # --- SSE/APM stages: rows of 8 bit positions x APM_BINS probabilities,
    # initialised to the identity map p(bin k) = logistic(bin-center logit)
    # so an untrained stage passes its input through (up to the piecewise-
    # linear quantisation) ---
    if spec.apm:
        from .core.meta import APM_BINS, APM_SPAN

        centers = -APM_SPAN + np.arange(APM_BINS) * (2 * APM_SPAN / (APM_BINS - 1))
        ident = 1.0 / (1.0 + np.exp(-centers))
        row = np.tile(ident.astype(np.float32), 8)  # (8*APM_BINS,)
        ltm["apm"] = jnp.broadcast_to(
            jnp.asarray(row), (S, meta.apm_total, 8 * APM_BINS)
        ).copy()

    # --- PPM byte model (device-native ModPPMD equivalent). The tables live
    # in SHORT-term memory mirroring the reference, whose entire PPMD heap is
    # serialized as short-term state and keeps updating during generation
    # (mod_ppmd.cpp:1-6, tester.cpp:358-366) ---
    if spec.ppm is not None:
        from .core.meta import PPM_ROW_W

        # widened rows: 256 counts + the owner tag at lane 256 (collisions
        # read as empty rows and are reclaimed on update - the tag rides the
        # row so no separate element scatter is needed; core.step._ppm_rows)
        stm["ppm_tbl"] = jnp.zeros((S, meta.ppm_total_rows, PPM_ROW_W), jnp.uint16)
        stm["ppm_top"] = jnp.full((S,), 255, i32)
        stm["ppm_bot"] = jnp.zeros((S,), i32)
        stm["ppm_mid"] = jnp.full((S,), 127, i32)
        # SEE escape correction: logit offset per (order, distinct bucket),
        # init 0 = pure PPM-C prior (mod_ppmd.cpp:465-496 reduced to a
        # learned logistic offset)
        stm["ppm_see"] = jnp.zeros(
            (S, len(spec.ppm.orders), spec.ppm.see_buckets), f32
        )

    # --- LSTM ---
    if spec.lstm is not None:
        ls = spec.lstm
        C, Hz = ls.num_cells, ls.horizon
        LI = ls.input_size + C + 1  # [aux, hidden, bias]
        OUT = ls.output_size
        # Xavier-uniform like lstm-layer.cpp:179-195 (our own PRNG; encoder and
        # decoder both derive the identical init from the fixed seed). The
        # reference's single weight row [one-hot symbol | input vec] is stored
        # split (w_sym | w_in) so the hot loop never slices it (layout copies).
        val = math.sqrt(6.0 / float(ls.input_size + ls.output_size))
        k1, k2 = jax.random.split(jax.random.PRNGKey(seed))
        w_sym = jax.random.uniform(k1, (3, C, OUT), f32, -val, val)
        w_in = jax.random.uniform(k2, (3, C, LI), f32, -val, val)
        w_in = w_in.at[0, :, LI - 1].set(1.0)  # forget-gate bias column = 1
        ltm["lstm"] = {
            "w_sym": jnp.broadcast_to(w_sym, (S, 3, C, OUT)).copy(),
            "sym_m": jnp.zeros((S, 3, C, OUT), f32),
            "sym_v": jnp.zeros((S, 3, C, OUT), f32),
            "w_in": jnp.broadcast_to(w_in, (S, 3, C, LI)).copy(),
            "in_m": jnp.zeros((S, 3, C, LI), f32),
            "in_v": jnp.zeros((S, 3, C, LI), f32),
            "gamma": jnp.ones((S, 3, C), f32),
            "beta": jnp.zeros((S, 3, C), f32),
            "gamma_m": jnp.zeros((S, 3, C), f32),
            "gamma_v": jnp.zeros((S, 3, C), f32),
            "beta_m": jnp.zeros((S, 3, C), f32),
            "beta_v": jnp.zeros((S, 3, C), f32),
            # (S, Hz, C+1, OUT): OUT minor for lane-friendly forward/update
            "out_w": jnp.zeros((S, Hz, C + 1, OUT), f32),
        }
        hidden = jnp.zeros((S, C + 1), f32).at[:, C].set(1.0)  # bias lane (lstm.cpp:31)
        layer_input = jnp.zeros((S, Hz, LI), f32).at[:, :, LI - 1].set(1.0)
        stm["lstm"] = {
            "probs": jnp.full((S, 256), 1.0 / 256, f32),  # byte-level output
            "top": jnp.full((S,), 255, i32),
            "bot": jnp.zeros((S,), i32),
            "mid": jnp.full((S,), 127, i32),
            "cell": jnp.zeros((S, C), f32),
            "hidden": hidden,
            "state_err": jnp.zeros((S, C), f32),
            "stored_err": jnp.zeros((S, C), f32),
            "old_input": jnp.zeros((S,), i32),
            "norm": jnp.zeros((S, 3, Hz, C), f32),
            "ivar": jnp.zeros((S, 3, Hz), f32),
            "gate_state": jnp.zeros((S, 3, Hz, C), f32),
            "tanh_state": jnp.zeros((S, Hz, C), f32),
            "in_gate": jnp.zeros((S, Hz, C), f32),
            "last_state": jnp.zeros((S, Hz, C), f32),
            "layer_input": layer_input,
            "in_hist": jnp.zeros((S, Hz), i32),
            "outputs": jnp.full((S, Hz, ls.output_size), 1.0 / ls.output_size, f32),
            "epoch": jnp.zeros((), i32),
            "update_steps": jnp.zeros((), i32),
        }

    coder = {
        "x1": jnp.zeros((S,), u32),
        "x2": jnp.full((S,), 0xFFFFFFFF, u32),
        "x": jnp.zeros((S,), u32),
        "wpos": jnp.zeros((S,), u32),
        "rpos": jnp.zeros((S,), u32),
    }

    # metrics: cumulative cross-entropy (bits) + per-column analysis EMA
    # (reference: Predictor::UpdateEntropy alpha=1e-5, predictor.cpp:439-469);
    # columns = predictions + L0/L1 mixer outputs + final (core.meta.analysis_names)
    n_cols = meta.n_pred + meta.mix_n0 + meta.mix_n1 + 1
    metrics = {
        "ent": jnp.zeros((S,), f32),
        "ema": jnp.full((S, n_cols), 1.0, f32),
    }

    return {"stm": stm, "ltm": ltm, "coder": coder, "metrics": metrics}


def state_bytes(state) -> int:
    """Total size of the state pytree in bytes."""
    return sum(x.size * x.dtype.itemsize for x in jax.tree_util.tree_leaves(state))
