"""The families under the planner's specs on the CPU: Mamba-2 (its
contraction-sharded mixer), Jamba (the hybrid loop, its windowed ring and
its MoE), Whisper (the encoder, the cross K/V and cross-attention) and
LLaVA (the image prefix), on (data × model) gloo grids where each rank
holds only its shards (``launch.sharding.shard_tree``) and computes its
share (``models.specs``):

* prefill and decode steps in case g (rows over data, the attention
  caches' sequence over model) and case h (rows over data × model), in
  bf16 (logits within ``LOGIT_TOL`` of one process, the hybrid stack's
  rule of ``test_torch_hybrid``, counts exact) and in float32 (logits
  within ``F32_TOL`` of the largest |logit|: the prefill of every family,
  and Mamba-2's decode steps; the decode attention kernel, row 5, takes
  bf16 only);
* the FSDP train step in float32: the loss, every gradient and every
  updated parameter within ``F32_TOL`` of its largest magnitude (the
  parameters where the clipped gradient is at least ``G_FLOOR``: AdamW's
  first update swings near its eps);
* every rank's held bytes equal to ``rank_bytes``, and the bytes each
  collective sent equal to the recording mode's (the same calls on
  ``meta`` tensors under ``launch.dist.dry_run()``);
* one case per family against the reference's single-device functions on
  the same weights, within that family's parity bound.

A 1 × 3 grid takes what does not divide: the reduced vocabulary (512) and
heads (4), so the embedding stays replicated and attention runs every
head, sequence-parallel in training, as the 16 × 16 records of Mamba-2,
Whisper and LLaVA do. One world of 4 ranks; what the ranks run is in
``torch_families_worker.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.models import decode_step as jdecode_step
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 to_torch)
from repro_torch.core import tree as T
from repro_torch.core.ver import build_bank_empty
from repro_torch.launch import dist as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.mesh import dry_context, spawn
from repro_torch.models import specs as SP
from repro_torch.models.model import init_params
from torch_threads import _one_thread  # noqa: F401

import torch_families_worker as FW

#: bf16 logits under specs against one process, and the port's bf16
#: logits against the reference's on the hybrid stack: the rule of
#: ``test_torch_hybrid`` (its 8-layer stack amplifies ulps).
LOGIT_TOL = 0.25
#: The port's bf16 logits against the reference's on the other families
#: (``test_torch_families``, ``test_torch_multimodal``).
FAMILY_TOL = 0.05
#: float32 logits, loss, gradients and updated parameters under specs
#: against one process: of the largest magnitude.
F32_TOL = 1e-4
#: Updated parameters are held where the clipped gradient is at least
#: this (AdamW's first update g / (|g| + 1e-8) turns on the last bits of
#: a gradient near 0; ROADMAP Queue 3).
G_FLOOR = 1e-6

#: family → (arch, prompt tokens, dense-row capacity). The capacity
#: divides 2 and 3 (the caches' sequence cuts over either model axis);
#: Jamba's ring (window 64) is 48 slots, which a case-g rank holds half
#: of, the owner of slot pos % 48 writing each new token's K/V.
FAMILIES = {"mamba": ("mamba2-130m", 16, 48),
            "jamba": ("jamba-v0_1-52b", 16, 48),
            "whisper": ("whisper-tiny", 16, 48),
            "llava": ("llava-next-34b", 16, 48)}
#: Whisper's reduced encoder takes 48 frames (a multiple of 2 and 3: its
#: training attention runs sequence-parallel on the 1 × 3 grid).
ENC_SEQ = 48
#: Training tokens per row (Mamba-2's and Jamba's SSD chunk is 16;
#: Whisper's 12 and LLaVA's 16 + 8 divide 3).
TRAIN_S = {"mamba": 16, "jamba": 16, "whisper": 12, "llava": 8}


def _configs(fam):
    arch = FAMILIES[fam][0]
    j, p = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    if fam == "whisper":
        j = dataclasses.replace(j, encoder_seq=ENC_SEQ)
        p = dataclasses.replace(p, encoder_seq=ENC_SEQ)
    return j, p


def _jbank(experts):
    """The reference's stacked int4 bank (group 32) with one expert
    published per hi slot (slot s holds expert 2s + 1)."""
    bank = jbuild_bank(experts, n_hi=2, lo_bits=4, group_size=32)
    L, E = experts["w_gate"].shape[:2]
    so = np.full((L, 2), -1, np.int32)
    sm = np.full((L, E), -1, np.int32)
    for s in range(2):
        e = 2 * s + 1
        for n in bank.hi:
            bank.hi[n] = bank.hi[n].at[:, s].set(experts[n][:, e])
        so[:, s], sm[:, e] = e, s
    bank.slot_owner, bank.slot_map = jnp.asarray(so), jnp.asarray(sm)
    return bank


def _moe_keys(cfg):
    return [str(p) for p in range(len(cfg.superblock_or_default()))
            if cfg.ffn_kind(p) == "moe"] if cfg.is_moe else []


def _strip(params, keys):
    """Serving params: the dense experts dropped (the bank serves them)."""
    blocks = dict(params["blocks"])
    for k in keys:
        blocks[k] = dict(blocks[k], moe=dict(blocks[k]["moe"], experts=None))
    return dict(params, blocks=blocks)


def _f32(tree):
    return T.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                      tree)


@pytest.fixture(scope="module")
def weights():
    return _weights()


def _weights():
    """Per family: (reference cfg, port cfg, reference params as numpy,
    reference banks {position: bank} or None)."""
    out = {}
    for i, fam in enumerate(FAMILIES):
        jcfg, cfg = _configs(fam)
        jp = jax.tree_util.tree_map(
            np.asarray, jinit_params(jax.random.PRNGKey(40 + i), jcfg))
        jb = {k: _jbank(jax.tree_util.tree_map(
            jnp.asarray, jp["blocks"][k]["moe"]["experts"]))
            for k in _moe_keys(jcfg)} or None
        out[fam] = (jcfg, cfg, jp, jb)
    return out


def _data(cfg, B, S, seed):
    """numpy-seeded inputs: tokens (B, S) and a VLM's patches or an
    encoder-decoder's frames (bf16 normal × 0.02), as numpy and tensors."""
    rng = np.random.default_rng(seed)
    np_out = {"tokens": rng.integers(1, cfg.vocab_size, (B, S))}
    if cfg.family == "vlm":
        np_out["image_embeds"] = (rng.standard_normal(
            (B, cfg.num_image_tokens, cfg.d_model)) * 0.02
        ).astype(jnp.bfloat16)
    if cfg.is_encoder_decoder:
        np_out["audio_embeds"] = (rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model)) * 0.02).astype(jnp.bfloat16)
    t = {k: (torch.from_numpy(v) if k == "tokens" else to_torch(v))
         for k, v in np_out.items()}
    return np_out, t


def _cases(weights, dev="cpu"):
    """The cases (name → (kind, args, kwargs)) of the 2 × 2 grid and of the
    1 × 3 grid, with their trees on ``dev`` ("meta": shapes only, for the
    recording mode)."""
    meta = dev == "meta"

    def params_of(fam, f32):
        jcfg, cfg, jp, _ = weights[fam]
        p = init_params(cfg, device="meta") if meta else \
            params_from_reference(jp)
        return _f32(p) if f32 else p

    def bank_of(fam):
        jcfg, cfg, jp, jb = weights[fam]
        if meta:
            E, d, f = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
            shapes = {"w_gate": (1, E, d, f), "w_up": (1, E, d, f),
                      "w_down": (1, E, f, d)}
            return {k: build_bank_empty(shapes, n_hi=2, lo_bits=4,
                                        group_size=32, device="meta")
                    for k in _moe_keys(cfg)}
        return {k: bank_from_reference(b) for k, b in jb.items()}

    def data_of(cfg, B, S, seed):
        if not meta:
            return _data(cfg, B, S, seed)[1]
        out = {"tokens": torch.empty((B, S), dtype=torch.int64,
                                     device="meta")}
        if cfg.family == "vlm":
            out["image_embeds"] = torch.empty(
                (B, cfg.num_image_tokens, cfg.d_model),
                dtype=torch.bfloat16, device="meta")
        if cfg.is_encoder_decoder:
            out["audio_embeds"] = torch.empty(
                (B, cfg.encoder_seq, cfg.d_model), dtype=torch.bfloat16,
                device="meta")
        return out

    def srv(fam, B, seed, f32=False, dispatch="padded", ep=False):
        _, cfg, _, jb = weights[fam]
        _, S, max_len = FAMILIES[fam]
        p, b = params_of(fam, f32), None
        if jb is not None and not f32:
            p, b = _strip(p, list(jb)), bank_of(fam)
        # float32 decode steps would reach row 5, which takes bf16 only.
        steps = FW.STEPS if not f32 or cfg.attn is None else 0
        data = data_of(cfg, B, S + steps, seed)
        return ("serve", (cfg, p, b, data),
                dict(max_len=max_len, steps=steps, dispatch=dispatch, ep=ep))

    def trn(fam, B, seed):
        _, cfg, _, _ = weights[fam]
        data = data_of(cfg, B, TRAIN_S[fam] + 1, seed)
        toks = data["tokens"]
        batch = dict(data, tokens=toks[:, :-1], labels=toks[:, 1:])
        return ("train", (cfg, params_of(fam, True), batch), {})

    cases = {}
    for i, fam in enumerate(FAMILIES):
        s = 100 * i
        cases[f"{fam}_h"] = srv(fam, 4, s + 1)
        cases[f"{fam}_g"] = srv(fam, 2, s + 2)
        cases[f"{fam}_h32"] = srv(fam, 4, s + 3, f32=True)
        cases[f"{fam}_g32"] = srv(fam, 2, s + 4, f32=True)
        cases[f"{fam}_train"] = trn(fam, 4, s + 5)
    cases["jamba_h_ep"] = srv("jamba", 4, 106, dispatch="ragged", ep=True)
    three = {}
    for i, fam in enumerate(("mamba", "whisper", "llava")):
        s = 1000 + 100 * i
        three[f"{fam}3_h"] = srv(fam, 3, s + 1)
        three[f"{fam}3_train"] = trn(fam, 3, s + 2)
    three["mamba3_32"] = srv("mamba", 3, 1003, f32=True)
    return {"cases": cases, "three": three}


@pytest.fixture(scope="module")
def setup(weights):
    return _cases(weights)


@pytest.fixture(scope="module")
def grid(setup, tmp_path_factory):
    return spawn(FW.world, 2, "cpu", setup, n_data=2, threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("families")))


@pytest.fixture(scope="module")
def single(setup):
    """The port's one-process runs of every case."""
    return {name: FW.RUN[kind](*args, None, **kw)
            for group in ("cases", "three")
            for name, (kind, args, kw) in setup[group].items()}


def _ranks(grid, name):
    return [r for r in grid if name in r]


SERVE = [f"{f}_{c}" for f in FAMILIES for c in ("h", "g")] + \
    ["jamba_h_ep", "mamba3_h", "whisper3_h", "llava3_h"]
SERVE32 = [f"{f}_{c}" for f in FAMILIES for c in ("h32", "g32")] + \
    ["mamba3_32"]
TRAIN = [f"{f}_train" for f in FAMILIES] + \
    ["mamba3_train", "whisper3_train", "llava3_train"]


def _forwards(run):
    return [run["prefill"]] + run["decode"]


def _check_counts(got, want, sl):
    """Per-row counts of the group rows equal to one process's rows."""
    for gc, wc in zip(got["counts"], want["counts"]):
        assert gc.keys() == wc.keys()
        for k in gc:
            assert torch.equal(gc[k], wc[k][:, sl]), k


# -- serving ----------------------------------------------------------------
def _alike(got, want, sl):
    """Per forward, the group rows whose tokens took the same experts in
    every MoE layer in that forward and every one before it (per-row
    counts equal; every row on a stack without MoE)."""
    B = sl.stop - sl.start
    so_far = np.ones(B, bool)
    out = []
    for gc, wc in zip(got["counts"], want["counts"]):
        assert gc.keys() == wc.keys()
        so_far &= (_row_counts(gc, B) ==
                   _row_counts({k: v[:, sl] for k, v in wc.items()},
                               B)).all(1)
        out.append(so_far.copy())
    return out


@pytest.mark.parametrize("name", SERVE)
def test_bf16_serving_matches_one_process(grid, single, name):
    """Prefill and STEPS decode steps in bf16, by the hybrid stack's rule:
    every rank's logits of its group rows within LOGIT_TOL of one
    process's on the rows routed alike so far (at least half of the
    (rank, row, forward) triples; a router near tie may swap an expert),
    every row's counts summing to top-k times its tokens, the ranks of a
    model group bit-equal."""
    want = single[name]
    ranks = _ranks(grid, name)
    assert ranks
    held = pairs = 0
    for r in ranks:
        got = r[name]
        sl = got["group"]
        assert len(got["decode"]) == FW.STEPS
        for g, w, ok in zip(_forwards(got), _forwards(want),
                            _alike(got, want, sl)):
            assert bool(torch.isfinite(g).all())
            d = (g.float() - w[sl].float()).abs().amax(-1).numpy()
            assert float(d[ok].max(initial=0.0)) <= LOGIT_TOL
            held += int(ok.sum())
            pairs += ok.size
        _check_whole(got)
    assert 2 * held >= pairs
    for a in ranks:
        for b in ranks:
            if a[name]["group"] == b[name]["group"]:
                assert torch.equal(a[name]["decode"][-1],
                                   b[name]["decode"][-1])


def _check_whole(run):
    """Drop-free: every row's per-row counts sum to top-k times its tokens
    in every MoE layer and forward (4 experts, top-2)."""
    for f, c in enumerate(run["counts"]):
        per = 2 * (run["prefill_tokens"] if f == 0 else 1)
        for k, v in c.items():
            assert bool((v.sum(-1) == per).all()), (f, k)


@pytest.mark.parametrize("name", SERVE32)
def test_f32_serving_matches_one_process(grid, single, name):
    """float32: the prefill's logits (and Mamba-2's decode steps') within
    F32_TOL of the largest |logit| of one process's; per-row counts
    equal (4 experts, top-2)."""
    want = single[name]
    for r in _ranks(grid, name):
        got = r[name]
        sl = got["group"]
        scale = max(float(w.abs().max()) for w in _forwards(want))
        for g, w in zip(_forwards(got), _forwards(want)):
            assert g.dtype == torch.float32
            err = float((g - w[sl]).abs().max())
            assert err <= F32_TOL * scale, (err, scale)
        _check_counts(got, want, sl)
    if name.startswith("mamba"):
        assert len(want["decode"]) == FW.STEPS


def test_regimes_and_layouts(grid, setup):
    """Jamba's MoE ran the padded regime over model (all-to-all with
    ``tokens_ep_sharded``), one call per MoE position and forward; the
    cases are the layouts they name: h rows over data × model, g rows
    over data with the attention caches' sequence over model; on the
    1 × 3 grid Mamba-2's embedding and projections stay whole."""
    calls = 4 * (1 + FW.STEPS)
    for r in grid:
        assert r["jamba_h"]["regimes"]["padded"] == calls
        assert r["jamba_h_ep"]["regimes"]["all_to_all"] == calls
    for name, (_, args, _) in setup["cases"].items():
        if name.endswith(("_h", "_g")):
            cfg, B = args[0], args[3]["tokens"].shape[0]
            pl = SH.ShardingPlanner(cfg, SH.GridShape(
                {"data": 2, "model": 2}, ("data", "model")))
            for rank in range(4):
                with D.dry_run():
                    ctx = dataclasses.replace(dry_context(
                        pl.mesh, rank), planner=pl, batch=B)
                    lay = SP.layout(ctx)
                assert lay.over_model == name.endswith("_h")
                assert lay.seq == name.endswith("_g")
    cfg = setup["three"]["mamba3_h"][1][0]
    whole = SH.held_bytes(init_params(cfg, device="meta"))
    for r in _ranks(grid, "mamba3_h"):
        assert r["mamba3_h"]["held"]["param"] == (whole, whole)


# -- training ---------------------------------------------------------------
def _assemble(ranks, key, dims):
    """The global tensors of ``key``'s (path, spec, shard) leaves from
    every rank's shards."""
    out = []
    for li in range(len(ranks[0][key])):
        path, spec, _ = ranks[0][key][li]
        shards = [(r["coords"], r[key][li][2]) for r in ranks]
        first = shards[0][1]
        shape = list(first.shape)
        for d, e in enumerate(spec):
            shape[d] *= _cut(e, dims)
        full = torch.zeros(shape, dtype=first.dtype)
        for (i, j), t in shards:
            idx = []
            for d, e in enumerate(spec):
                k = _index(e, i, j, dims)
                idx.append(slice(k * t.shape[d], (k + 1) * t.shape[d]))
            full[tuple(idx)] = t
        out.append((path, full))
    return out


def _names(e):
    return () if e is None else (e,) if isinstance(e, str) else tuple(e)


def _cut(e, dims):
    n = 1
    for a in _names(e):
        n *= dims[1] if a == "model" else dims[0]
    return n


def _index(e, i, j, dims):
    names = _names(e)
    if "model" in names and len(names) > 1:
        return i * dims[1] + j
    return j if "model" in names else i if names else 0


def _train_ranks(grid, name):
    ranks = _ranks(grid, name)
    if len(ranks) == 4:
        return [dict(r, **r[name]) for r in ranks], (2, 2)
    return [dict(r, coords=(0, i), **r[name]) for i, r in enumerate(ranks)], \
        (1, 3)


@pytest.mark.parametrize("name", TRAIN)
def test_train_step_matches_one_process(grid, single, name):
    """One float32 train step under the FSDP specs: the loss and gradient
    norm within F32_TOL relative, every gathered gradient within F32_TOL
    of its leaf's largest |gradient|, every updated parameter within
    F32_TOL of its leaf's largest magnitude where the clipped gradient
    is at least G_FLOOR."""
    want = single[name]
    ranks, dims = _train_ranks(grid, name)
    loss, gnorm = float(want["loss"]), float(want["gnorm"])
    for r in ranks:
        assert abs(float(r["loss"]) - loss) <= F32_TOL * abs(loss)
        assert abs(float(r["gnorm"]) - gnorm) <= F32_TOL * gnorm
    clip = min(1.0, 1.0 / (gnorm + 1e-9))
    grads = _assemble(ranks, "grads", dims)
    new = _assemble(ranks, "new", dims)
    for (path, g), (_, _, wg), (_, p), (wpath, _, wp) in zip(
            grads, want["grads"], new, want["new"]):
        assert path == wpath
        err = float((g - wg).abs().max())
        assert err <= F32_TOL * max(float(wg.abs().max()), 1e-30), \
            ("grad", path, err)
        held = (wg.abs() * clip >= G_FLOOR) | (wg == 0)
        err = float(((p - wp).abs() * held).max())
        assert err <= F32_TOL * max(float(wp.abs().max()), 1e-30), \
            ("param", path, err)


# -- bytes ------------------------------------------------------------------
@pytest.mark.parametrize("name", SERVE + SERVE32 + TRAIN)
def test_ranks_hold_rank_bytes(grid, name):
    """Every rank holds exactly ``rank_bytes`` of each of its trees."""
    ranks = _ranks(grid, name)
    assert ranks
    for r in ranks:
        held = r[name]["held"]
        assert {"param", "input"} <= set(held)
        for kind, (got, want) in held.items():
            assert got == want, kind


@pytest.fixture(scope="module")
def recorded(weights):
    """The cases on ``meta`` trees under the recording mode, for rank 0
    and the last rank of each grid: the bytes each collective sent."""
    cases = _cases(weights, "meta")
    out = {}
    for group, grid_shape, ranks in (
            ("cases", {"data": 2, "model": 2}, (0, 3)),
            ("three", {"data": 1, "model": 3}, (0, 2))):
        g = SH.GridShape(grid_shape, ("data", "model"))
        for rank in ranks:
            for name, (kind, args, kw) in cases[group].items():
                with D.dry_run():
                    ctx = dry_context(g, rank)
                    out[(name, rank)] = FW.RUN[kind](*args, ctx, **kw)[
                        "sent"]
    return out


@pytest.mark.parametrize("name", SERVE + SERVE32 + TRAIN)
def test_sent_bytes_match_recording(grid, recorded, name):
    """Rank 0's and the last rank's bytes, by collective and axis, in the
    prefill, the first decode step and the train step, equal the
    recording mode's on ``meta`` trees of the same shapes."""
    ranks = _ranks(grid, name)
    for i in (0, len(ranks) - 1):
        got = ranks[i][name]["sent"]
        want = recorded[(name, i if len(ranks) == 3 else 3 * (i > 0))]
        assert got == want
        assert any(got.values())


# -- the reference ----------------------------------------------------------
def _row_counts(counts, B):
    rows = [np.asarray(counts[k]).transpose(1, 0, 2).reshape(B, -1)
            for k in sorted(counts)]
    return np.concatenate(rows, axis=1) if rows else np.zeros((B, 0))


@pytest.fixture(scope="module")
def reference(weights):
    """The reference's single-device prefill and decode steps on each
    family's case h (the same weights, bank and inputs), bf16: the logits
    of every forward and its per-row counts."""
    out = {}
    for i, fam in enumerate(FAMILIES):
        jcfg, cfg, jp, jb = weights[fam]
        _, S, max_len = FAMILIES[fam]
        B = 4
        npd, _ = _data(cfg, B, S + FW.STEPS, 100 * i + 1)
        toks = jnp.asarray(npd["tokens"], jnp.int32)
        batch = {"tokens": toks[:, :S]}
        n = S
        for k in ("image_embeds", "audio_embeds"):
            if k in npd:
                batch[k] = jnp.asarray(npd[k])
        if "image_embeds" in npd:
            n += cfg.num_image_tokens
        kw = dict(capacity_factor=FW.CF, moe_dispatch="padded",
                  per_row_counts=True)
        pj = jax.tree_util.tree_map(jnp.asarray, jp)
        if jb is not None:
            pj = jax.tree_util.tree_map(jnp.asarray, _strip(jp, list(jb)))
        lg, caches, jc = jprefill(pj, jcfg, batch,
                                  jinit_caches(jcfg, B, max_len), bank=jb,
                                  lengths=jnp.full((B,), n, jnp.int32), **kw)
        logits, counts = [np.asarray(lg)], [_row_counts(jc, B)]
        for t in range(FW.STEPS):
            lg, caches, jc = jdecode_step(pj, jcfg, toks[:, S + t],
                                          jnp.full((B,), n + t, jnp.int32),
                                          caches, bank=jb, **kw)
            logits.append(np.asarray(lg))
            counts.append(_row_counts(jc, B))
        out[fam] = (logits, counts)
    return out


@pytest.mark.parametrize("fam", list(FAMILIES))
def test_matches_reference(grid, reference, fam):
    """Each family's case h under specs against the reference's single
    device: logits within the family's parity bound (LOGIT_TOL on the
    hybrid stack, FAMILY_TOL elsewhere) on every row whose tokens took
    the same experts in both packages in that forward (at least half of
    the (rank, row, forward) triples: a router near tie between the two
    packages' arithmetic may swap an expert, as in ``test_torch_hybrid``;
    every row on a stack without MoE)."""
    logits, jcounts = reference[fam]
    name = f"{fam}_h"
    tol = LOGIT_TOL if fam == "jamba" else FAMILY_TOL
    held = pairs = 0
    for r in grid:
        run = r[name]
        sl = run["group"]
        B = sl.stop - sl.start
        for g, c, w, jc in zip(_forwards(run), run["counts"], logits,
                               jcounts):
            ok = (_row_counts(c, B) == jc[sl]).all(1)
            np.testing.assert_allclose(g.float().numpy()[ok], w[sl][ok],
                                       rtol=0, atol=tol)
            held += int(ok.sum())
            pairs += B
    assert 2 * held >= pairs
    if fam != "jamba":
        assert held == pairs


def test_init_params_without_experts():
    """``init_params(..., experts=False)`` (what a bank-served model on the
    card draws: ``chip_smoke``'s Jamba under specs) leaves every MoE
    layer's dense experts None and draws every other leaf of the whole
    tree, in its shape and dtype."""
    cfg = get_config("jamba-v0_1-52b", reduced=True)
    full = dict(SH.leaf_paths(init_params(cfg, device="meta")))
    bare = dict(SH.leaf_paths(init_params(cfg, device="cpu",
                                          experts=False)))
    keys = _moe_keys(cfg)
    assert keys
    for k in keys:
        assert init_params(cfg, device="meta", experts=False)[
            "blocks"][k]["moe"]["experts"] is None
    want = {p: t for p, t in full.items() if "['experts']" not in p}
    assert bare.keys() == want.keys()
    for p, t in bare.items():
        assert (t.shape, t.dtype) == (want[p].shape, want[p].dtype), p
        assert t.device.type == "cpu"
