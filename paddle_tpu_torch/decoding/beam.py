"""Beam search as paged-cache forks.

The port's copy of ``paddle_tpu/decoding/beam.py``. A hypothesis fork
is bookkeeping: duplicate the parent's int32 block table, bump the
refcount on every fully-written page, and let the engine's
copy-on-write guard copy the one partially-written page if and when the
two hypotheses diverge inside it. Beams share their whole common prefix
in device memory, and a "reorder" never moves cache bytes.

A :class:`BeamJob` owns one request's hypotheses. The job's slots are
ordinary engine slots: its rows ride the same decode step (one captured
CUDA graph on the card) as every greedy or sampled request in the batch,
the op's ``emit_topk`` plane returning each row's top-K log-probs.
Scoring replicates ``transformer_stack_beam_search`` exactly: per-parent
top-K candidates merged by (score desc, parent*V+token asc), frozen
(eos) hypotheses contributing their unchanged score, GNMT
``((5+len)/6)^alpha`` length normalization at the end. That tie order
is what makes the beams token-exact against the fused op.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from .params import BeamParams


class _Hyp:
    """One live or frozen hypothesis. ``slot`` is the engine slot whose
    block table holds this hypothesis's cache view (None once frozen —
    a frozen hypothesis needs no more decode work, only its score)."""

    __slots__ = ("slot", "score", "tokens", "alive")

    def __init__(self, slot: Optional[int], score: float,
                 tokens: List[int], alive: bool):
        self.slot = slot
        self.score = float(score)
        self.tokens = tokens
        self.alive = alive


class BeamJob:
    """One beam-search request riding the continuous batch.

    Lifecycle: the engine admits the parent slot normally (prefill /
    prefix hit / chunked streaming all apply) and parks ``K-1`` hold
    slots for the job; the parent's first top-K row expands the initial
    hypotheses (beam 0 keeps the parent's cache, the rest fork); each
    decode tick's top-K rows rerank the beam set — surviving children
    reuse or fork their parent's slot, dead branches release pages back
    to the pool. Pool pressure DEFERS a rerank (the job's slots sit out
    decode ticks until pages free, retried by ``serve_step``) rather
    than failing mid-flight, mirroring the engine's admission-defer
    contract.
    """

    def __init__(self, engine, request, prompt: np.ndarray,
                 max_new: int, params: BeamParams,
                 parent_slot: int, hold_slots: List[int]):
        self.engine = engine
        self.request = request
        self.prompt = np.asarray(prompt, np.int64)
        self.max_new = int(max_new)
        self.params = params
        self.K = int(params.beam_size)
        self.eos_id = -1 if params.eos_id is None else int(params.eos_id)
        self.parent_slot = parent_slot
        self.holds: List[int] = list(hold_slots)
        self.hyps: List[_Hyp] = []
        self.expanded = False
        self.done = False
        # a rerank the pool could not satisfy, retried each tick
        self._pending: Optional[list] = None

    # -- slot inventory ---------------------------------------------------
    @property
    def waiting(self) -> bool:
        return self._pending is not None

    def live_slots(self) -> List[int]:
        return [h.slot for h in self.hyps if h.slot is not None]

    # -- expansion --------------------------------------------------------
    def on_parent_row(self, topv: np.ndarray, topi: np.ndarray) -> None:
        """First top-K row for the parent (from prefill completion, or
        from the first decode tick on a full prefix hit): expand into K
        hypotheses. Beam 0 inherits the parent slot's cache; the others
        fork it (shared written pages, fresh future pages)."""
        eng = self.engine
        n_written = int(self.prompt.size)  # prompt K/V rows on the device
        plan = []  # (token, score, alive)
        for k in range(self.K):
            tok = int(topi[k])
            plan.append((tok, float(topv[k]), self._alive(tok)))
        n_alive = sum(1 for _, _, a in plan if a)
        if not eng._beam_can_fork(self, max(0, n_alive - 1), n_written):
            self._pending = ["expand", np.asarray(topv), np.asarray(topi)]
            eng._beam_park(self)
            return
        self.expanded = True
        self.hyps = []
        parent_used = False
        for tok, score, alive in plan:
            if not alive:
                self.hyps.append(_Hyp(None, score, [tok], False))
                continue
            if not parent_used:
                parent_used = True
                slot = self.parent_slot
            else:
                slot = eng._beam_fork(self.parent_slot, self.holds.pop(),
                                      n_written)
            eng._tok[slot] = tok
            eng._pos[slot] = n_written
            self.hyps.append(_Hyp(slot, score, [tok], True))
        if not parent_used:  # every first token froze: parent unneeded
            eng._beam_release(self.parent_slot, self)
        self._maybe_finish()

    # -- rerank -----------------------------------------------------------
    def on_decode_rows(self, rows: Dict[int, Tuple[np.ndarray, np.ndarray]]
                       ) -> None:
        """One decode tick advanced every alive hypothesis: merge each
        row's top-K continuations with the frozen hypotheses' standing
        scores, keep the global top-K, and reshape the slot set.
        Candidate order replicates the fused reference's
        ``top_k(cand.reshape(K*V))``: score desc, flat parent·V+token
        asc on ties."""
        if self.done or self._pending is not None:
            return
        V = self.engine.spec.vocab_size
        n_before = len(self.hyps[0].tokens)
        cands = []  # (score, flat_index, parent_idx, token)
        for idx, h in enumerate(self.hyps):
            if not h.alive:
                tok = self.eos_id if self.eos_id >= 0 else 0
                cands.append((h.score, idx * V + tok, idx, tok))
                continue
            topv, topi = rows[h.slot]
            for j in range(self.K):
                tok = int(topi[j])
                cands.append((h.score + float(topv[j]), idx * V + tok,
                              idx, tok))
        cands.sort(key=lambda c: (-c[0], c[1]))
        self._apply_rerank(cands[:self.K], n_before)

    def _apply_rerank(self, selected: list, n_before: int) -> None:
        eng = self.engine
        n_written = int(self.prompt.size) + n_before
        # children per parent, in global selection order
        by_parent: Dict[int, List[int]] = {}
        for i, c in enumerate(selected):
            by_parent.setdefault(c[2], []).append(i)
        alive_children = {
            p_idx: sum(1 for i in sel_ids
                       if self.hyps[p_idx].alive
                       and self._alive(selected[i][3]))
            for p_idx, sel_ids in by_parent.items()}
        # 1. dead branches release FIRST: their slots park as holds and
        # their pages free up for the forks below (idempotent across a
        # park/retry — a released parent's slot goes None)
        for idx, h in enumerate(self.hyps):
            if h.slot is not None and not alive_children.get(idx):
                eng._beam_release(h.slot, self)
                h.slot = None
        # 2. feasibility before ANY fork mutates state: park whole or
        # apply whole
        forks = sum(max(0, n - 1) for n in alive_children.values())
        if forks and not eng._beam_can_fork(self, forks, n_written):
            self._pending = ["rerank", selected, n_before]
            eng._beam_park(self)
            return
        # 3. assign: each surviving parent's first alive child inherits
        # its slot, the rest fork it
        new_hyps: List[Optional[_Hyp]] = [None] * len(selected)
        for p_idx, sel_ids in by_parent.items():
            parent = self.hyps[p_idx]
            parent_used = False
            for i in sel_ids:
                score, _flat, _p, tok = selected[i]
                if not parent.alive:  # frozen parent: stays frozen
                    new_hyps[i] = _Hyp(None, score,
                                       parent.tokens + [tok], False)
                    continue
                if not self._alive(tok):  # freezes now
                    new_hyps[i] = _Hyp(None, score,
                                       parent.tokens + [tok], False)
                    continue
                if not parent_used:
                    parent_used = True
                    slot = parent.slot
                else:
                    slot = eng._beam_fork(parent.slot, self.holds.pop(),
                                          n_written)
                eng._tok[slot] = tok
                eng._pos[slot] = n_written
                new_hyps[i] = _Hyp(slot, score, parent.tokens + [tok],
                                   True)
        self.hyps = [h for h in new_hyps if h is not None]
        self._maybe_finish()

    def _alive(self, tok: int) -> bool:
        return (tok != self.eos_id) if self.eos_id >= 0 else True

    def retry(self) -> bool:
        """Re-attempt a pool-deferred expansion/rerank. Returns True when
        the job unblocked (its slots rejoin the decode plane)."""
        if self._pending is None:
            return True
        pending, self._pending = self._pending, None
        if pending[0] == "expand":
            self.on_parent_row(pending[1], pending[2])
        else:
            self._apply_rerank(pending[1], pending[2])
        if self._pending is None:
            self.engine._beam_unpark(self)
            return True
        return False

    # -- completion -------------------------------------------------------
    def _maybe_finish(self) -> None:
        if self._pending is not None or not self.hyps:
            return
        n = len(self.hyps[0].tokens)
        if n >= self.max_new or all(not h.alive for h in self.hyps):
            self._finish()

    def _final_arrays(self):
        """(tokens [K, N], raw scores [K]) padded exactly like the fused
        reference: frozen hypotheses trail eos (0 with no eos)."""
        N = self.max_new
        fill = self.eos_id if self.eos_id >= 0 else 0
        toks = np.full((len(self.hyps), N), fill, np.int64)
        scores = np.zeros(len(self.hyps), np.float64)
        for i, h in enumerate(self.hyps):
            t = np.asarray(h.tokens[:N], np.int64)
            toks[i, :t.size] = t
            scores[i] = h.score
        return toks, scores

    def _finish(self) -> None:
        self.done = True
        toks, scores = self._final_arrays()
        N = self.max_new
        alpha = self.params.length_penalty
        if alpha:
            if self.eos_id >= 0:
                has = (toks == self.eos_id).any(axis=1)
                first = np.argmax(toks == self.eos_id, axis=1) + 1
                gen_len = np.where(has, np.minimum(first, N),
                                   N).astype(np.float64)
            else:
                gen_len = np.full(len(self.hyps), float(N))
            scores = scores / (((5.0 + gen_len) / 6.0) ** alpha)
        order = np.argsort(-scores, kind="stable")
        toks, scores = toks[order], scores[order]
        ids = np.concatenate(
            [np.repeat(self.prompt[None, :], toks.shape[0], axis=0),
             toks], axis=1)
        self.engine._beam_finish(self, ids, scores.astype(np.float32))
