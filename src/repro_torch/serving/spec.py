"""Self-speculative decoding on the low-precision tier (the port of the
reference's ``serving/spec.py``).

The always-resident lo copy of every expert is a free draft model: the
whole MoE on the all-lo view of the served banks (``serving.lobanks``: the
same buffers, every hi slot disowned) is the cheap approximate forward that
speculation needs. No draft weights exist anywhere.

One round per engine step for the rows of the scheduler's ``spec`` group:

1. **draft** — ``k`` greedy tokens per row (``models.spec_draft``: k chained
   decode steps on the all-lo view, each step's argmax on the device fed to
   the next);
2. **verify** — the ``k + 1`` positions on the served banks
   (``models.spec_verify``). Each position runs the decode step's own math,
   so a verified prefix is what the plain engine would have computed: at
   temperature 0 the emitted tokens equal the non-speculative ones;
3. **accept** — rejection sampling against each request's
   ``SamplingParams`` (``accept_burst``): the output distribution is the
   target model's;
4. **rewind** — rejected positions roll back: write positions retreat,
   paged blocks that only ever held rejected positions return to the pool
   (``KVLease.unwind``; full attention only), and on dense rows, and on
   the pool under a sliding window, the lanes the burst wrote are restored
   from a snapshot (a lane past a row's depth may wrap onto a live slot; a
   ring's draft overwrites slots whose positions the verify still
   attends). On stacks with Mamba positions the draft graph copies the
   recurrent rows into a static snapshot before drafting and back after,
   the verify returns each row's state after every step, and each row of
   the round takes its state after its last accepted step
   (``select_rows``, the reference's ``_select_ssm``; a device-side
   gather, no host read); rows outside the round take the snapshot.

Each ladder width's draft and verify are one CUDA graph each on the card
(``serving.graphs.DecodeGraph``), over one set of static inputs of this
decoder and the engine's graph memory pool; on the CPU and inside
``eager()`` they run op by op. Only the verify's (W, B) argmax, the drafted
tokens and the per-step per-row router counts cross to the host, as one
int32 buffer; rows that sample also ship their (W, V) logits, gathered on
the device first.

Hotness: only the verify counts of ACCEPTED steps reach
``backend.observe``: draft traffic and rejected positions never move
promotions. Draft depth adapts from each REQUEST's own acceptance EMA over a
power-of-two ladder (one graph pair per width), so a request's burst
boundaries, and with them the sampling draws it consumes, do not depend on
its neighbours in the batch.
"""
from __future__ import annotations

import time
import weakref
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.model import spec_draft, spec_verify
from repro_torch.models.ssm import MambaCache
from repro_torch.serving.engine import _pack, _unpack
from repro_torch.serving.graphs import DecodeGraph, StaticInputs
from repro_torch.serving.sampler import (STREAM_ACCEPT, STREAM_BONUS,
                                         STREAM_RESIDUAL, RequestSampler,
                                         categorical, sampling_probs)


def accept_burst(sampler: RequestSampler, drafts: np.ndarray,
                 target_logits: Optional[np.ndarray],
                 target_top: Optional[np.ndarray] = None
                 ) -> Tuple[int, List[int]]:
    """Rejection-sample one row's burst. ``drafts``: (d,) draft tokens;
    ``target_logits``: (d+1, V) f32 verify logits (``target_logits[j]`` is
    the target distribution for the token after consuming ``drafts[:j]``).
    A greedy request only needs ``target_top`` ((d+1,) device-side argmax
    of the verify logits) — the engine then never ships the full (W, B, V)
    logits to host on the greedy fast path.

    Returns ``(n_accepted, emitted)`` where ``emitted`` is the accepted
    prefix plus exactly one target-sampled token (the correction on
    rejection, the bonus on full acceptance) — so every round emits at
    least one token and the output distribution matches sampling from the
    target one token at a time. The draft proposal is greedy (a point mass
    at ``d``): accept with probability ``p(d)``; the residual is ``p`` with
    ``d`` removed, renormalized."""
    sp = sampler.sp
    d = int(drafts.shape[0])
    out: List[int] = []
    a = 0
    if sp.greedy:
        if target_top is None:
            target_top = np.argmax(target_logits, axis=-1)
        for j in range(d):
            t = int(target_top[j])
            out.append(t)
            if t != int(drafts[j]):
                return a, out                      # correction token
            a += 1
        out.append(int(target_top[d]))             # bonus token
        return a, out
    rnd = sampler.spec_round
    for j in range(d):
        p = sampling_probs(target_logits[j], sp)
        dj = int(drafts[j])
        if sampler.uniform(STREAM_ACCEPT, rnd, j) < p[dj]:
            out.append(dj)
            a += 1
            continue
        q = p.copy()
        q[dj] = 0.0
        s = q.sum()
        if s <= 0.0:                               # p was (numerically) 1_d
            masked = np.array(target_logits[j], np.float64)
            masked[dj] = -np.inf
            out.append(int(np.argmax(masked)))
        else:
            out.append(categorical(q / s,
                                   sampler.uniform(STREAM_RESIDUAL, rnd, j)))
        return a, out
    out.append(categorical(sampling_probs(target_logits[d], sp),
                           sampler.uniform(STREAM_BONUS, rnd)))
    return a, out


def select_rows(stacked: Dict[str, MambaCache], sel: torch.Tensor
                ) -> Dict[str, MambaCache]:
    """Per-row rollback of recurrent state (the reference's
    ``_select_ssm``): leaves (S, nsb, B, ...) stacked over the verify's
    steps, ``sel`` (B,) int64 each row's last accepted step → leaves
    (nsb, B, ...) holding each row's state after it."""
    rows = torch.arange(sel.shape[0], device=sel.device)
    return {p: MambaCache(*(t[sel, :, rows].movedim(0, 1) for t in c))
            for p, c in stacked.items()}


class SpecDecoder:
    """The engine's speculative decoder (built when ``EngineConfig.spec_k
    > 0``): the depth ladder, one draft and one verify graph per ladder
    width (``graphs[k] = (draft, verify)``, captured at first use), and the
    round statistics ``stats()`` adds to the engine's."""

    def __init__(self, engine):
        self.eng = weakref.proxy(engine)
        e = engine.ecfg
        self.k_max = max(1, int(e.spec_k))
        ladder, v = [], 1
        while v < self.k_max:
            ladder.append(v)
            v *= 2
        ladder.append(self.k_max)
        self.ladder = ladder                       # power-of-two k buckets
        self.adaptive = bool(e.spec_adaptive)
        self.ema_alpha = 0.25
        self.ema = 0.75                            # aggregate (telemetry)
        self.rounds = 0
        self.row_rounds = 0              # (round, active row) pairs
        self.draft_total = 0
        self.accepted_total = 0
        self.verified_total = 0
        self.capture_s = 0.0
        self.last: Dict[str, object] = {}
        B, W = e.max_slots, self.k_max + 1
        dev = engine.device
        fields = [("tokens", (B,), torch.int64), ("pos", (B,), torch.int64),
                  ("step_valid", (W, B), torch.bool)]
        if engine.pool is not None:
            fields += [("wblk", (W, B), torch.int64),
                       ("woff", (W, B), torch.int64),
                       ("table", (B, engine._nb), torch.int32)]
        self.inputs = StaticInputs(fields, dev)
        # The drafted tokens stay on the device: the draft graph writes
        # them here and the verify graph reads them.
        self._drafted = torch.zeros((self.k_max, B), dtype=torch.int64,
                                    device=dev)
        # The Mamba rows before a round: the draft graph writes them here
        # first and restores them last, so the verify starts from them and
        # rows outside the round come back from them.
        self._mamba_snap = {p: MambaCache(*(torch.zeros_like(t)
                                            for t in engine.caches[p]))
                            for p in engine._mamba_pos}
        # The rollback's inputs: each row's last accepted step and whether
        # it was in the round, pushed by one host→device copy.
        self._roll = StaticInputs([("sel", (B,), torch.int64),
                                   ("act", (B,), torch.bool)], dev) \
            if engine._mamba_pos else None
        self._shapes: Dict[int, Dict[str, tuple]] = {}
        self._out_host: Dict[int, torch.Tensor] = {}
        me = weakref.ref(self)
        self.graphs: Dict[int, Tuple[DecodeGraph, DecodeGraph]] = {
            k: (DecodeGraph(lambda k=k: me()._draft_fn(k), self.inputs, dev,
                            engine._graph_pool, graphed=engine.graphed),
                DecodeGraph(lambda k=k: me()._verify_fn(k), self.inputs, dev,
                            engine._graph_pool, graphed=engine.graphed))
            for k in ladder}

    # ------------------------------------------------------------------
    def _pick_k(self, ema: float) -> int:
        """Largest ladder depth an acceptance EMA supports: the expected
        accepted run of a per-token acceptance rate r is r/(1-r) — there is
        no point drafting much deeper than the run that survives. Depth is
        chosen from each REQUEST's own EMA (``handle.spec_ema``): row-local
        adaptation keeps a request's burst boundaries — and therefore its
        sampling-PRNG stream consumption — independent of batch
        composition."""
        target = ema / max(1e-6, 1.0 - ema)
        k = 1
        for v in self.ladder:
            if v <= max(1.0, target):
                k = v
        return min(k, self.k_max)

    def stats(self) -> Dict[str, float]:
        return {
            "spec_rounds": float(self.rounds),
            "spec_row_rounds": float(self.row_rounds),
            "draft_tokens": float(self.draft_total),
            "verified_tokens": float(self.verified_total),
            "accept_rate": (self.accepted_total / self.draft_total)
            if self.draft_total else 0.0,
        }

    # -- the two steps over the static inputs -----------------------------
    def _kw(self, steps: int) -> dict:
        """The step keywords of a burst of ``steps`` decode steps: its
        write lanes on the pool are the first ``steps`` rows."""
        eng, d = self.eng, self.inputs.dev
        kw = dict(capacity_factor=eng.ecfg.capacity_factor,
                  row_capacity=eng._row_cap_decode,
                  moe_dispatch=eng.moe_dispatch)
        if eng.pool is not None:
            kw["paged"] = {"table": d["table"],
                           "write_blk": d["wblk"][:steps],
                           "write_off": d["woff"][:steps]}
        return kw

    def _draft_fn(self, k: int) -> tuple:
        """k draft steps on the all-lo view: step j consumes the token at
        ``pos + j`` (step j of the verify's lanes) and is valid where the
        verify's step j + 1 is."""
        eng, d = self.eng, self.inputs.dev
        for p, snap in self._mamba_snap.items():
            for s, t in zip(snap, eng.caches[p]):
                s.copy_(t)
        drafted = spec_draft(eng.params, eng.cfg, d["tokens"], d["pos"],
                             eng.caches, d["step_valid"][1:k + 1],
                             bank=eng.lo_banks, **self._kw(k))
        self._drafted[:k].copy_(drafted)
        for p, snap in self._mamba_snap.items():
            for s, t in zip(snap, eng.caches[p]):
                t.copy_(s)
        return ()

    def _verify_fn(self, k: int) -> tuple:
        """The k + 1 verify steps on the served banks over the last token
        and the drafts: (logits (W, B, V) float32, one int32 buffer of the
        (W, B) argmax, the (k, B) drafts and the per-step per-row counts,
        and the Mamba rows after each step: {position: (W, nsb, B, ...)
        leaves})."""
        eng, d = self.eng, self.inputs.dev
        W = k + 1
        toks = torch.cat([d["tokens"][None], self._drafted[:k]])
        logits, counts, ssm = spec_verify(
            eng.params, eng.cfg, toks, d["pos"], eng.caches,
            d["step_valid"][:W], bank=eng.banks, **self._kw(W))
        self._shapes[k] = {p: tuple(v.shape) for p, v in counts.items()}
        head = torch.cat([torch.argmax(logits, -1).reshape(-1),
                          self._drafted[:k].reshape(-1)])
        return logits, _pack(head, counts), ssm

    # -- the lanes a burst writes ------------------------------------------
    def _restores(self) -> bool:
        """Whether a burst's lanes are snapshotted and restored: always on
        dense rows, on the pool only under a sliding window (full-attention
        lanes are fresh private blocks or the trash block), the
        reference's rule."""
        eng = self.eng
        return bool(eng._attn_pos) and (
            eng.pool is None or eng.cfg.attn.sliding_window is not None)

    def _lanes(self, pos0: np.ndarray, W: int):
        """The lanes (B, W) the burst writes, on the device (dense rows:
        (row, slot ``pos % C``); the pool: the resolved (block, offset)
        of ``_fill``), and a snapshot of their K/V: {position: (k, v)} each
        (B, W, nsb, Hkv, hd)."""
        eng = self.eng
        if eng.pool is None:
            i1 = eng._dev((pos0[:, None] + np.arange(W)[None, :]) %
                          eng._C_attn)
            i0 = torch.arange(i1.shape[0], device=i1.device)[:, None]
        else:
            h = self.inputs.host
            i0 = eng._dev(h["wblk"][:W].T)
            i1 = eng._dev(h["woff"][:W].T)
        snap = {p: (eng.caches[p].k[:, i0, :, i1].clone(),
                    eng.caches[p].v[:, i0, :, i1].clone())
                for p in eng._attn_pos}
        return (i0, i1), snap

    def _restore(self, lanes, snap, mask: np.ndarray) -> None:
        """Write the snapshot back into the lanes where ``mask`` ((B, W)
        bool) holds; the other lanes keep what the burst wrote."""
        eng = self.eng
        i0, i1 = lanes
        m = eng._dev(mask, torch.bool)[:, :, None, None, None]
        for p, (sk, sv) in snap.items():
            c = eng.caches[p]
            for a, s in ((c.k, sk), (c.v, sv)):
                a[:, i0, :, i1] = torch.where(m, s, a[:, i0, :, i1])

    # ------------------------------------------------------------------
    def _fill(self, active, step_valid: np.ndarray, depth: np.ndarray,
              cows: List[Tuple[int, int]]) -> Dict[int, List[int]]:
        """Write the round's inputs into the host mirror of the static
        buffers; on the pool, resolve every write lane up front (alloc and
        copy-on-write; lanes past a row's depth and vacant rows go to the
        trash block). Returns, per row, the logical blocks the burst
        allocated fresh (unwound if they end up holding only rejected
        positions)."""
        eng = self.eng
        h = self.inputs.host
        W = step_valid.shape[0]
        h["tokens"][:] = eng.tokens
        h["pos"][:] = eng.pos
        h["step_valid"][:] = False
        h["step_valid"][:W] = step_valid
        fresh: Dict[int, List[int]] = {}
        if eng.pool is None:
            return fresh
        h["wblk"][:] = 0
        h["woff"][:] = 0
        h["table"][:] = -1
        for i, r in active:
            seen: List[int] = []
            for j in range(int(depth[i]) + 1):
                p = int(eng.pos[i]) + j
                jb = (p % eng._C_pad) // eng._bt
                was_free = int(r.lease.table[jb]) < 0
                h["wblk"][j, i], h["woff"][j, i] = eng._ensure_write(
                    r.lease, p, cows)
                if was_free and jb not in seen:
                    seen.append(jb)
            fresh[i] = seen
            h["table"][i] = r.lease.table
        return fresh

    def _capture(self, k: int) -> None:
        """Capture width k's draft and verify with every row vacant (no
        count; on the pool every write goes to the trash block, on dense
        rows the lanes they write are restored afterwards)."""
        eng = self.eng
        t0 = time.perf_counter()
        B = eng.ecfg.max_slots
        W = k + 1
        self._fill([], np.zeros((W, B), bool), np.zeros(B, np.int64), [])
        # Every row vacant: on the pool every write goes to the trash
        # block; dense rows' lanes come back.
        dense = eng.pool is None and self._restores()
        if dense:
            lanes, snap = self._lanes(eng.pos.copy(), W)
        for g in self.graphs[k]:
            if g.needs_capture:
                g.capture()
        if dense:
            self._restore(lanes, snap, np.ones((B, W), bool))
        dt = time.perf_counter() - t0
        self.capture_s += dt
        eng.capture_s += dt

    def _rollback_mamba(self, ssm: Dict[str, MambaCache],
                        accepts: np.ndarray, row_valid: np.ndarray) -> None:
        """Each row of the round takes its Mamba rows after its last
        accepted step; every other row its pre-round snapshot. One
        host→device copy of the (B,) steps and the mask (written after the
        verify's outputs reached the host, so no earlier copy still reads
        the mirror), then gathers on the device."""
        h, d = self._roll.host, self._roll.dev
        h["sel"][:] = np.maximum(accepts, 0)
        h["act"][:] = row_valid
        self._roll.push()
        act = d["act"]
        for p, picked in select_rows(ssm, d["sel"]).items():
            for t, new, old in zip(self.eng.caches[p], picked,
                                   self._mamba_snap[p]):
                keep = act.view((1, -1) + (1,) * (t.dim() - 2))
                t.copy_(torch.where(keep, new, old))

    def round(self, active, finished) -> bool:
        """Run one draft/verify round over the active rows. Returns False
        (the caller falls back to the plain single-token step) when no row
        has speculation headroom — e.g. every request needs just one more
        token, or sits one position from its sequence cap."""
        eng = self.eng
        B = eng.ecfg.max_slots
        depth = np.zeros(B, np.int64)
        for i, h in active:
            rem = h.request.max_new_tokens - len(h.tokens)
            k_h = self._pick_k(h.spec_ema) if self.adaptive else self.k_max
            depth[i] = max(0, min(k_h, rem - 1,
                                  eng.ecfg.max_len - 1 - int(eng.pos[i])))
        k = int(depth.max())
        if k <= 0:
            return False
        # The burst length rounds UP to the ladder (one graph pair per
        # width); the step mask neutralizes the padded steps.
        k = next(v for v in self.ladder if v >= k)
        W = k + 1
        draft, verify = self.graphs[k]
        if draft.needs_capture or verify.needs_capture:
            self._capture(k)
        row_valid = np.zeros(B, bool)
        for i, _ in active:
            row_valid[i] = True
        # ``occupied`` (every slot holding a request, in this round or not)
        # drives the restore: a lane past a row's depth can wrap onto a
        # live slot of any occupied row.
        occupied = np.asarray([h is not None for h in eng.slots], bool)
        step_valid = row_valid[None, :] & \
            (np.arange(W)[:, None] <= depth[None, :])
        t0 = time.perf_counter()
        pos0 = eng.pos.copy()
        cows: List[Tuple[int, int]] = []
        fresh = self._fill(active, step_valid, depth, cows)
        eng._apply_copies(cows)
        restore = self._restores()
        if restore:
            lanes, snap = self._lanes(pos0, W)

        draft.run()
        if restore:
            # The verify reads the pre-burst contents through its own
            # step masks: every occupied lane back.
            self._restore(lanes, snap, np.repeat(occupied[:, None], W,
                                                 axis=1))
        logits, packed, ssm = verify.run()
        out = self._out_host.get(k)
        if out is None:
            out = self._out_host[k] = torch.empty(
                packed.shape, dtype=torch.int32,
                pin_memory=eng.device.type == "cuda")
        out.copy_(packed)
        head, counts_np = _unpack(out.numpy().copy(), W * B + k * B,
                                  self._shapes[k])
        top = head[:W * B].reshape(W, B)
        drafted = head[W * B:].reshape(k, B)
        samp_rows = [i for i, h in active if not h.sampler.greedy]
        samp_logits: Dict[int, np.ndarray] = {}
        if samp_rows:
            idx = torch.as_tensor(samp_rows, dtype=torch.int64) \
                .to(logits.device)
            sub = logits[:, idx].float().cpu().numpy()
            samp_logits = {i: sub[:, j] for j, i in enumerate(samp_rows)}
        dt = eng._elapsed(t0)

        # ---- rejection sampling per row ---------------------------------
        # -1 for rows outside this round: the restore mask (lane j restored
        # iff j > accepts) then covers all their lanes.
        accepts = np.full(B, -1, np.int64)
        emitted: Dict[int, List[int]] = {}
        n_draft = n_accept = 0
        for i, h in active:
            d = int(depth[i])
            row_logits = samp_logits.get(i)
            a, toks = accept_burst(
                h.sampler, drafted[:d, i],
                None if row_logits is None else row_logits[:d + 1],
                target_top=top[:d + 1, i])
            h.sampler.end_round()
            accepts[i] = a
            emitted[i] = toks
            n_draft += d
            n_accept += a

        # ---- hotness: the verify counts of ACCEPTED steps only ----------
        eng._note_dispatch(counts_np)
        accept_mask = row_valid[None, :] & \
            (np.arange(W)[:, None] <= accepts[None, :])        # (W, B)
        obs = {kk: (v * accept_mask[:, None, :, None]).sum(axis=0)
               for kk, v in counts_np.items()}
        # A row whose accepted steps routed through a quarantined cell
        # emitted tokens computed on its unreal rows.
        eng._note_degraded(obs, active)
        stall = eng.backend.observe(obs, dt, prefill=False,
                                    row_valid=row_valid)
        eng._stall_clock += stall
        if stall:
            for _, h in active:
                h.stall_exposure_s += stall
        latency = dt + stall
        eng.decode_times.append(latency)
        eng._tpot_ema = latency if eng._tpot_ema == 0.0 else \
            0.9 * eng._tpot_ema + 0.1 * latency
        eng.last_row_counts = obs
        # The round's per-step counts and accept mask, for inspection.
        self.last = {"counts": counts_np, "accept_mask": accept_mask}

        # ---- rewind ------------------------------------------------------
        if self._mamba_snap:
            self._rollback_mamba(ssm, accepts, row_valid)
        if restore:
            self._restore(lanes, snap, occupied[:, None] & (
                np.arange(W)[None, :] > accepts[:, None]))
        if eng.pool is not None and eng.cfg.attn.sliding_window is None:
            for i, h in active:
                new_pos = int(pos0[i]) + int(accepts[i]) + 1
                for jb in fresh.get(i, ()):
                    if jb * eng._bt >= new_pos:
                        h.lease.unwind(jb)

        # ---- emit + bookkeeping -----------------------------------------
        eng._tpot_sum += latency * len(active)
        kept_total = 0
        now = eng._now()
        for i, h in active:
            toks = emitted[i]
            n_before = len(h.tokens)
            h.tokens.extend(toks)
            h.last_progress_s = now
            eng.tokens[i] = toks[-1]
            eng.pos[i] += int(accepts[i]) + 1
            # _done may TRUNCATE at a mid-burst EOS: only tokens that
            # survive count toward latency and the spec meters.
            done = eng._done(h)
            kept = len(h.tokens) - n_before
            kept_total += kept
            # step_times stays per TOKEN: the round's latency spreads over
            # the tokens it emitted for this row.
            h.step_times.extend([latency / max(1, kept)] * kept)
            for kk, v in counts_np.items():
                if v.ndim == 4 and kk in h.expert_counts:
                    h.expert_counts[kk] += (v[:, :, i].astype(np.int64) *
                                            accept_mask[:, i][:, None, None]
                                            ).sum(axis=0)
            d = int(depth[i])
            if d:
                # Row-local acceptance EMA → row-local draft depth.
                r = int(accepts[i]) / d
                h.spec_ema = (1 - self.ema_alpha) * h.spec_ema + \
                    self.ema_alpha * r
            if done:
                eng._finish(h, finished)
        eng._tpot_tokens += kept_total
        eng.counters["steps"] += 1
        self.rounds += 1
        self.row_rounds += len(active)
        self.draft_total += n_draft
        self.accepted_total += n_accept
        self.verified_total += kept_total
        if eng.tracer is not None:
            eng.tracer.instant("spec_round", cat="engine",
                               rows=len(active), drafted=int(n_draft),
                               accepted=int(n_accept),
                               emitted=int(kept_total))
        if n_draft:
            r = n_accept / n_draft
            self.ema = (1 - self.ema_alpha) * self.ema + self.ema_alpha * r
        return True
