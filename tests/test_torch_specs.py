"""The planner's specs executed on the CPU: ``prefill``, ``decode_step``
and the train step on (data × model) gloo grids where each rank holds
only its shards (``launch.sharding.shard_tree``) and computes its share
(``models.specs``), against the port's single device and the reference's
single-device functions; the collectives' backwards by gradcheck; row
5's log-sum-exp output.

The reference's own sharded path is no oracle here (on this JAX version
its sharded tests stop before their comparisons); its single-device
``prefill``, ``decode_step`` and ``jax.grad`` of ``loss_fn`` are.

One world of 4 ranks (a 2 × 2 grid, and a 1 × 3 grid over ranks 0-2);
what the ranks run is in ``torch_specs_worker.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.kernels.flash_decode import flash_decode as jflash_decode
from repro.models import decode_step as jdecode_step
from repro.models import init_caches as jinit_caches
from repro.models import init_params as jinit_params
from repro.models import prefill as jprefill
from repro.training import TrainConfig as JTrainConfig
from repro.training import loss_fn as jloss_fn
from repro.training import make_train_step as jmake_train_step
from repro.training.adamw import adamw_init as jadamw_init
from repro_torch.configs import get_config
from repro_torch.convert import bank_from_reference, params_from_reference
from repro_torch.core import tree as T
from repro_torch.kernels import ops
from repro_torch.launch import dist as D
from repro_torch.launch import sharding as SH
from repro_torch.launch.dist import DistContext, dist_ctx
from repro_torch.launch.mesh import spawn
from repro_torch.models import model as MD
from repro_torch.models import moe as M
from torch_threads import _one_thread  # noqa: F401

import torch_specs_worker as W

#: bf16 logits under specs against one device: within 2^-6 of the largest
#: |logit| (the card's bar for the data axis's padded regimes: partial
#: products summed over model in float32 and rounded once, a router over
#: fewer rows, tip a logit by a bf16 step or two).
SPEC_TOL = 2 ** -6
#: The port's bf16 logits against the reference's (``test_torch_mesh``).
LOGIT_ATOL = 0.1
#: float32 loss, relative; gradients and updated parameters, of each
#: leaf's largest magnitude.
LOSS_RTOL, GRAD_TOL = 1e-5, 1e-4


def _jf32(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float32)
        if hasattr(x, "dtype") and x.dtype == jnp.bfloat16 else x, tree)


def _f32(tree):
    return T.tree_map(lambda t: t.float() if t.is_floating_point() else t,
                      tree)


def _mixed(cfg):
    """4 q heads over 1 KV head: on a model axis of 2 the q heads divide
    and the KV heads do not (the 30B's 32/4 at model 16, in small)."""
    return dataclasses.replace(cfg, attn=dataclasses.replace(
        cfg.attn, n_kv_heads=1))


#: name → (arch, variant of the reduced config: None, "mixed" or a vocab).
ARCHS = {"moe30": ("qwen3-moe-30b-a3b", None),
         "mixed": ("qwen3-moe-30b-a3b", "mixed"),
         "moe80": ("qwen3-moe-80b-a3b", None),
         "granite_v": ("granite-moe-1b-a400m", 49155),
         "granite": ("granite-moe-1b-a400m", None),
         "llama": ("llama3_2-3b", None),
         "deepseek": ("deepseek-7b", None),
         "phi4": ("phi4-mini-3.8b", None),
         "danube": ("h2o-danube-3-4b", None)}


def _configs(name):
    arch, var = ARCHS[name]
    if isinstance(var, int):
        return (jget_config(arch).reduced(vocab=var),
                get_config(arch).reduced(vocab=var))
    j, p = jget_config(arch, reduced=True), get_config(arch, reduced=True)
    return (_mixed(j), _mixed(p)) if var == "mixed" else (j, p)


def _jbank(experts):
    """The reference's stacked int4 bank with one expert published per
    hi slot (slot s holds expert 2s + 1)."""
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


@pytest.fixture(scope="module")
def weights():
    """Per config: (reference cfg, port cfg, reference params as numpy,
    reference bank or None)."""
    out = {}
    for i, name in enumerate(ARCHS):
        jcfg, cfg = _configs(name)
        jp = jax.tree_util.tree_map(
            np.asarray, jinit_params(jax.random.PRNGKey(i), jcfg))
        jb = None
        if name in ("moe30", "mixed", "moe80"):
            jb = _jbank(jax.tree_util.tree_map(
                jnp.asarray, jp["blocks"]["0"]["moe"]["experts"]))
        out[name] = (jcfg, cfg, jp, jb)
    return out


def _tokens(vocab, B, n, seed):
    return torch.from_numpy(np.random.default_rng(seed).integers(
        1, vocab, (B, n)))


def _strip(params):
    """Serving params: the dense experts dropped (the bank serves them)."""
    blocks = {k: dict(bp, moe=dict(bp["moe"], experts=None))
              if "moe" in bp else bp for k, bp in params["blocks"].items()}
    return dict(params, blocks=blocks)


@pytest.fixture(scope="module")
def setup(weights):
    """The cases every rank runs: serving in bf16 (case h: rows over data
    × model; g: rows over data, the caches' sequence over model; rows
    over data only; rows replicated), training in float32 under FSDP."""
    def srv(name, B, seed, dispatch="padded", ep=False, bank=True,
            per_row=False):
        jcfg, cfg, jp, jb = weights[name]
        p = params_from_reference(jp)
        b = None
        if jb is not None and bank:
            p, b = _strip(p), {"0": bank_from_reference(jb)}
        toks = _tokens(cfg.vocab_size, B, W.S + W.STEPS, seed)
        return ("serve", (cfg, p, b, toks), dict(dispatch=dispatch, ep=ep,
                                                 per_row=per_row))

    def trn(name, B, seed, nmb=1):
        jcfg, cfg, jp, _ = weights[name]
        toks = _tokens(cfg.vocab_size, B, W.TRAIN_S + 1, seed)
        return ("train", (cfg, _f32(params_from_reference(jp)), toks),
                dict(nmb=nmb))

    cases = {
        "moe30_h": srv("moe30", 8, 1),
        "moe30_g": srv("moe30", 2, 2),
        "moe30_h_ep": srv("moe30", 8, 3, "ragged", ep=True),
        "moe30_g_ep": srv("moe30", 2, 4, "ragged", ep=True),
        "moe30_h_rows": srv("moe30", 8, 23, "ragged", ep=True, per_row=True),
        "moe30_g_rows": srv("moe30", 2, 24, per_row=True),
        "mixed_h": srv("mixed", 4, 5),
        "mixed_g": srv("mixed", 2, 6),
        "moe80_h": srv("moe80", 4, 7, "ragged", ep=True),
        "granite_v_data": srv("granite_v", 6, 8),
        "granite_v_repl": srv("granite_v", 3, 9),
        "llama_h": srv("llama", 4, 10),
        "deepseek_g": srv("deepseek", 2, 11),
        "phi4_h": srv("phi4", 4, 12),
        "danube_g": srv("danube", 2, 13),
        "train_granite": trn("granite", 4, 14),
        "train_granite_mb": trn("granite", 4, 15, nmb=2),
        "train_granite_v": trn("granite_v", 4, 16),
        "train_mixed": trn("mixed", 4, 17),
        "train_llama": trn("llama", 2, 18),
    }
    three = {
        "llama3_h": srv("llama", 3, 19),
        "llama3_g": srv("llama", 2, 20),
        "moe30_3": srv("moe30", 3, 21),
        "train_llama3": trn("llama", 3, 22),
    }
    return {"cases": cases, "three": three}


@pytest.fixture(scope="module")
def grid(setup, tmp_path_factory):
    return spawn(W.world, 2, "cpu", setup, n_data=2, threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("specs")))


@pytest.fixture(scope="module")
def single(setup):
    """The port's single-device runs of every case."""
    run = {"serve": W.serve, "train": W.train}
    return {name: run[kind](*args, None, **kw)
            for group in ("cases", "three")
            for name, (kind, args, kw) in setup[group].items()}


def _ranks(grid, name):
    return [r for r in grid if name in r]


def _rows(x, sl):
    return x[sl]


# -- the collectives --------------------------------------------------------
def test_grid_layout_is_data_major(grid):
    assert [r["coords"] for r in grid] == [(0, 0), (0, 1), (1, 0), (1, 1)]


@pytest.mark.parametrize("name", ["all_gather", "reduce_scatter",
                                  "all_reduce", "all_to_all", "exchange"])
@pytest.mark.parametrize("axis", ["model", "data", "tokens"])
def test_collective_backward_gradcheck(grid, name, axis):
    """Each collective's backward is its adjoint: gradcheck in float64 on
    the spawned world, each rank of the axis the probe in turn."""
    for r in grid:
        assert r["gradcheck"][(name, axis)] is True


# -- serving ----------------------------------------------------------------
SERVE = ("moe30_h", "moe30_g", "moe30_h_ep", "moe30_g_ep", "moe30_h_rows",
         "moe30_g_rows", "mixed_h",
         "mixed_g", "moe80_h", "granite_v_data", "granite_v_repl", "llama_h",
         "deepseek_g", "phi4_h", "danube_g", "llama3_h", "llama3_g",
         "moe30_3")


def _within(got, want, tol=SPEC_TOL):
    got, want = got.float(), want.float()
    err = float((got - want).abs().max())
    assert err <= tol * float(want.abs().max()), (err, float(
        want.abs().max()))


@pytest.mark.parametrize("name", SERVE)
def test_serving_matches_single_device(grid, single, name):
    """Prefill and STEPS decode steps under specs: every rank's logits of
    its group rows within 2^-6 of the largest |logit| of the single
    device's, the ranks of a model group bit-equal, counts of the whole
    batch equal to the single device's."""
    want = single[name]
    ranks = _ranks(grid, name)
    assert ranks
    for r in ranks:
        got = r[name]
        sl = got["group"]
        _within(got["prefill"], want["prefill"][sl])
        for g, w in zip(got["decode"], want["decode"]):
            _within(g, w[sl])
        for gc, wc in zip(got["counts"], want["counts"]):
            assert gc.keys() == wc.keys()
            for k in gc:        # per-row counts: the group's rows
                w = wc[k][:, sl] if wc[k].dim() == 3 else wc[k]
                assert torch.equal(gc[k], w), k
    for a in ranks:
        for b in ranks:
            if a[name]["group"] == b[name]["group"]:
                assert torch.equal(a[name]["decode"][-1],
                                   b[name]["decode"][-1])


@pytest.mark.parametrize("name", SERVE)
def test_serving_ranks_hold_rank_bytes(grid, name):
    """Every rank holds exactly ``rank_bytes`` of its params, bank, caches
    and inputs, and less than the whole where a leaf is cut."""
    for r in _ranks(grid, name):
        held = r[name]["held"]
        assert {"param", "cache", "input"} <= set(held)
        for kind, (got, want) in held.items():
            assert got == want, kind


def test_serving_regimes(grid):
    """The MoE layers ran the model-axis regimes on the group's tokens:
    the padded regime, or the all-to-all under ``tokens_ep_sharded``; E =
    4 over a model axis of 3 the whole-bank fallback; never a data-axis
    regime."""
    for r in grid:
        assert r["moe30_h"]["regimes"]["padded"] == 2 * (1 + W.STEPS)
        assert r["moe30_h_ep"]["regimes"]["all_to_all"] == 2 * (1 + W.STEPS)
        assert not {"padded_dp", "padded_ff", "all_to_all_dp"} & \
            set(r["moe30_h"]["regimes"])
    for r in _ranks(grid, "moe30_3"):
        assert r["moe30_3"]["regimes"].get("replicated") == 2 * (1 + W.STEPS)


def _sent_decode(cfg, B, dp, mn, ep):
    """What one rank sends in one decode step of the 2-layer 30B reduced
    stack with its bank, ``B`` rows on a dp × mn grid (every cut the
    planner makes: heads, vocabulary rows and columns, experts): by
    collective and axis."""
    a, E = cfg.attn, cfg.moe.num_experts
    d, hd, V = cfg.d_model, a.head_dim, cfg.vocab_size
    nsb = cfg.n_superblocks()
    over = B % (dp * mn) == 0
    Bg = B // dp
    Bo = Bg // mn if over else Bg
    hq, hk = a.n_heads // mn, a.n_kv_heads // mn
    ring = lambda n: 2 * (mn - 1) * n // mn
    ring_d = lambda n: 2 * (dp - 1) * n // dp
    out = {c: {x: 0 for x in D.AXES} for c in D.SENT_BYTES}
    model = {"all_to_all": 0, "all_gather": 0, "all_reduce": 0}
    if over:
        model["all_gather"] += 2 * Bo * 8 * (mn - 1)       # token, pos
    model["all_reduce"] += ring(Bg * d * 4)                 # embedding
    per = {"all_to_all": 0, "all_gather": 0, "all_reduce": 0}
    if over:
        per["all_to_all"] += (Bg * hq * hd + 2 * Bg * hk * hd) * 2 * \
            (mn - 1) // mn                                  # q, k, v
        per["all_to_all"] += Bg * hq * hd * 2 * (mn - 1) // mn   # o back
    else:
        per["all_gather"] += (Bg * hq * hd + 2 * Bg * hk * hd) * 2 * \
            (mn - 1)                                        # every head
        per["all_gather"] += Bg * a.n_heads * (hd * 2 + 4) * (mn - 1)
    per["all_reduce"] += ring(Bg * d * 4)                   # wo
    cap = M.moe_capacity(B, cfg.moe, W.CF)
    cap_l = max(8, (cap // dp + 7) // 8 * 8)
    if ep and Bg % mn == 0:           # else the padded regime (T_g < N)
        S_rows = M.ep_payload_rows(Bg, cfg.moe.top_k, E // mn, cap_l, mn)
        per["all_to_all"] += 2 * (mn - 1) * S_rows * d * 2 + \
            (mn - 1) * (E // mn) * 8
        tok = {"all_gather": Bg // mn * d * 2 * (mn - 1),
               "all_reduce": ring((E + 3) * 8)}
    else:
        per["all_reduce"] += ring(Bg * d * 4) + ring(2 * 8)  # y; means
        per["all_gather"] += (E // mn) * 4 * (mn - 1)        # counts
        tok = {}
    data = {"all_reduce": ring_d(E * 8) + ring_d((E + 1) * 8) +
            ring_d(E * 4)}
    for c, n in model.items():
        out[c]["model"] += n
    for c, n in per.items():
        out[c]["model"] += nsb * n
    for c, n in tok.items():
        out[c]["tokens"] += nsb * n
    for c, n in data.items():
        out[c]["data"] += nsb * n
    out["all_gather"]["model"] += Bg * V // mn * 4 * (mn - 1)   # logits
    return out


@pytest.mark.parametrize("name, B, ep", [("moe30_h", 8, False),
                                         ("moe30_g", 2, False),
                                         ("moe30_h_ep", 8, True),
                                         ("moe30_g_ep", 2, True)])
def test_decode_sent_bytes(grid, setup, name, B, ep):
    """The bytes each collective sent in one decode step, by axis, equal
    the formula from the shapes (``_sent_decode``) on every rank."""
    cfg = setup["cases"][name][1][0]
    want = _sent_decode(cfg, B, 2, 2, ep)
    for r in grid:
        assert r[name]["sent"] == want


def _row_counts(counts, B):
    """(B, nsb·E) per-row router counts over every MoE position ((B, 0)
    on a dense stack)."""
    rows = [np.asarray(counts[k]).transpose(1, 0, 2).reshape(B, -1)
            for k in sorted(counts)]
    return np.concatenate(rows, axis=1) if rows else np.zeros((B, 0))


@pytest.fixture(scope="module")
def reference(weights, setup):
    """The reference's single-device prefill and decode on the same
    weights, bank and tokens, for three serving cases; per forward the
    rows whose experts the port's single device chose alike (per-row
    counts of both packages equal), where a router near tie between the
    packages' arithmetic has not swapped an expert."""
    out = {}
    for name, arch in (("moe30_h", "moe30"), ("mixed_h", "mixed"),
                       ("llama_h", "llama")):
        jcfg, cfg, jp, jb = weights[arch]
        _, params, bank_t, toks_t = setup["cases"][name][1]
        toks = jnp.asarray(toks_t.numpy(), jnp.int32)
        B = toks.shape[0]
        kw = dict(capacity_factor=W.CF, moe_dispatch="padded",
                  per_row_counts=True)
        bank = None if jb is None else {"0": jb}
        pj = jax.tree_util.tree_map(jnp.asarray, jp)
        caches_t = MD.init_caches(cfg, B, W.MAX_LEN, device="cpu")
        lg, caches, jc = jprefill(pj, jcfg, {"tokens": toks[:, :W.S]},
                                  jinit_caches(jcfg, B, W.MAX_LEN),
                                  bank=bank, **kw)
        with torch.no_grad():
            _, tc = MD.prefill(params, cfg, toks_t[:, :W.S], caches_t,
                               torch.full((B,), W.S), bank=bank_t, **kw)
        logits, agree = [np.asarray(lg)], []
        agree.append((_row_counts(jc, B) == _row_counts(tc, B)).all(1))
        for t in range(W.STEPS):
            lg2, caches, jc = jdecode_step(pj, jcfg, toks[:, W.S + t],
                                           jnp.int32(W.S + t), caches,
                                           bank=bank, **kw)
            with torch.no_grad():
                _, tc = MD.decode_step(params, cfg, toks_t[:, W.S + t],
                                       torch.full((B,), W.S + t), caches_t,
                                       bank=bank_t, **kw)
            logits.append(np.asarray(lg2))
            agree.append(agree[-1] & (_row_counts(jc, B) ==
                                      _row_counts(tc, B)).all(1))
        out[name] = (logits, agree)
    return out


@pytest.mark.parametrize("name", ["moe30_h", "mixed_h", "llama_h"])
def test_serving_matches_reference(grid, reference, name):
    """The grid's logits against the reference's single device on the same
    weights: within the port's LOGIT_ATOL on every row routed alike by
    both packages (at least half of them)."""
    logits, agree = reference[name]
    for r in grid:
        sl = r[name]["group"]
        got = [r[name]["prefill"]] + r[name]["decode"]
        for g, w, ok in zip(got, logits, agree):
            ok = ok[sl]
            assert ok.sum() * 2 >= len(ok)
            np.testing.assert_allclose(g.float().numpy()[ok], w[sl][ok],
                                       rtol=0, atol=LOGIT_ATOL)


# -- training ---------------------------------------------------------------
TRAIN = ("train_granite", "train_granite_v", "train_mixed", "train_llama",
         "train_llama3")


def _assemble(ranks, key, dims):
    """The global tensors of ``key``'s (path, spec, shard) leaves from
    every rank's shards: each cut dim placed at its axis index (model:
    the model index, data: the data index, both: data major)."""
    out = []
    n = len(ranks[0][key])
    for li in range(n):
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


def _cut(e, dims):
    if e is None:
        return 1
    names = (e,) if isinstance(e, str) else e
    n = 1
    for a in names:
        n *= dims[1] if a == "model" else dims[0]
    return n


def _index(e, i, j, dims):
    if e is None:
        return 0
    names = (e,) if isinstance(e, str) else e
    if "model" in names and len(names) > 1:
        return i * dims[1] + j
    return j if "model" in names else i


def _train_ranks(grid, name):
    """The ranks that ran ``name``, each with its coordinates on that
    grid (2 × 2, or 1 × 3 over ranks 0-2), and the grid's dims."""
    ranks = _ranks(grid, name)
    if len(ranks) == 4:
        return ranks, (2, 2)
    return [dict(r, coords=(0, i)) for i, r in enumerate(ranks)], (1, 3)


@pytest.mark.parametrize("name", TRAIN)
def test_train_loss_grads_and_step_match_single_device(grid, single, name):
    """One train step under FSDP specs: the loss within 1e-5 relative of
    one device's, every gathered gradient and every parameter after the
    AdamW step within 1e-4 of its leaf's largest magnitude."""
    ranks, dims = _train_ranks(grid, name)
    want = single[name]
    for r in ranks:
        assert abs(r[name]["loss"] - want["loss"]) <= \
            LOSS_RTOL * abs(want["loss"])
        assert abs(r[name]["gnorm"] - want["gnorm"]) <= \
            LOSS_RTOL * abs(want["gnorm"]) + 1e-6
    merged = [dict(r, coords=r["coords"], **r[name]) for r in ranks]
    for key in ("grads", "new"):
        got = _assemble(merged, key, dims)
        for (path, g), (wpath, _, w) in zip(got, want[key]):
            assert path == wpath
            err = float((g.float() - w.float()).abs().max())
            assert err <= GRAD_TOL * max(float(w.abs().max()), 1e-30), \
                (key, path, err)


@pytest.mark.parametrize("name", TRAIN)
def test_train_ranks_hold_rank_bytes(grid, name):
    """Every rank holds exactly ``rank_bytes`` of its params, AdamW state
    and inputs under the FSDP specs."""
    ranks, _ = _train_ranks(grid, name)
    for r in ranks:
        for kind, (got, want) in r[name]["held"].items():
            assert got == want, kind
        assert set(r[name]["held"]) == {"param", "adamw", "input"}


def test_train_microbatches_match_single_device(grid, single, weights,
                                               setup):
    """Two microbatches under specs: microbatch m is the global chunk of
    rows [m·B/2, (m+1)·B/2), cut over data (``shard_tree(...,
    microbatches=2)``), as the reference's reshape before its scan makes
    it. On the same batch, the loss and gradient norm within 1e-5
    relative and every parameter after the step within 1e-4 of its
    leaf's largest magnitude, of one device's two-microbatch step and of
    the reference's ``make_train_step(microbatches=2)``."""
    jcfg, _, jp, _ = weights["granite"]
    toks = setup["cases"]["train_granite_mb"][1][2].numpy()
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    p32 = _jf32(jax.tree_util.tree_map(jnp.asarray, jp))
    jt = JTrainConfig(capacity_factor=W.CF, microbatches=2)
    jp2, _, jm = jmake_train_step(jcfg, jt)(p32, jadamw_init(p32), jb)
    jnew = [torch.from_numpy(np.array(x))
            for x in jax.tree_util.tree_leaves(jp2)]
    mine = single["train_granite_mb"]
    wants = {"port": (mine["loss"], mine["gnorm"],
                      [w for _, _, w in mine["new"]]),
             "reference": (float(jm["loss"]), float(jm["gnorm"]), jnew)}
    ranks, dims = _train_ranks(grid, "train_granite_mb")
    merged = [dict(r, **r["train_granite_mb"]) for r in ranks]
    got = _assemble(merged, "new", dims)
    for who, (loss, gnorm, new) in wants.items():
        for r in ranks:
            assert abs(r["train_granite_mb"]["loss"] - loss) <= \
                LOSS_RTOL * abs(loss), who
            assert abs(r["train_granite_mb"]["gnorm"] - gnorm) <= \
                LOSS_RTOL * abs(gnorm), who
        for (path, g), w in zip(got, new):
            err = float((g - w).abs().max())
            assert err <= GRAD_TOL * float(w.abs().max()), (who, path)


def test_train_matches_reference(grid, weights, setup):
    """The grid's train step against the reference's single device: every
    gathered gradient within 1e-4 of its leaf's largest |gradient| of
    ``jax.grad`` of the reference's ``loss_fn``; the loss within 1e-5
    relative and each updated parameter within 1e-4 of its leaf's largest
    magnitude of the reference's step."""
    jcfg, _, jp, _ = weights["granite"]
    toks = setup["cases"]["train_granite"][1][2].numpy()
    jb = {"tokens": jnp.asarray(toks[:, :-1]),
          "labels": jnp.asarray(toks[:, 1:])}
    p32 = _jf32(jax.tree_util.tree_map(jnp.asarray, jp))
    jt = JTrainConfig(capacity_factor=W.CF)
    jg = jax.grad(lambda q: jloss_fn(q, jcfg, jb, jt)[0])(p32)
    jp2, _, jm = jmake_train_step(jcfg, jt)(p32, jadamw_init(p32), jb)
    ranks, dims = _train_ranks(grid, "train_granite")
    for r in ranks:
        assert abs(r["train_granite"]["loss"] - float(jm["loss"])) <= \
            LOSS_RTOL * abs(float(jm["loss"]))
    merged = [dict(r, **r["train_granite"]) for r in ranks]
    for key, ref in (("grads", jg), ("new", jp2)):
        jflat = [np.asarray(x) for x in jax.tree_util.tree_leaves(ref)]
        for (path, g), w in zip(_assemble(merged, key, dims), jflat):
            err = float(np.abs(g.numpy() - w).max())
            assert err <= GRAD_TOL * float(np.abs(w).max()), (key, path)


# -- refusals and the kernel ------------------------------------------------
def test_planned_context_defaults_to_the_card():
    """A context with a planner and no device is on the card, or raises
    where there is none, as every entry point of the port; shard_tree
    keeps each leaf on its own device."""
    cfg = get_config("granite-moe-1b-a400m", reduced=True)
    pl = SH.ShardingPlanner(cfg, SH.GridShape({"data": 1, "model": 1},
                                              ("data", "model")))
    if torch.cuda.is_available():
        assert DistContext(None, 0, 1, planner=pl, batch=2).device.type == \
            "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            DistContext(None, 0, 1, planner=pl, batch=2)
    ctx = DistContext(None, 0, 1, device="cpu", planner=pl, batch=2)
    params = MD.init_params(cfg, device="cpu")
    local = SH.shard_tree(params, "param", pl, ctx)
    assert all(t.device.type == "cpu" for t in T.leaves(local))
    assert SH.held_bytes(local) == SH.rank_bytes(
        MD.init_params(cfg, device="meta"), "param", pl, SH.grid_of(ctx))


RULE_ARCHS = ["mamba2-130m", "jamba-v0_1-52b", "whisper-tiny",
              "llava-next-34b"]


@pytest.fixture(scope="module")
def rule_grid(tmp_path_factory):
    """A 2 × 1 grid serving each of ``RULE_ARCHS`` with ``row_capacity``
    on 3 rows, which do not split over data."""
    import torch_families_worker as FW
    return spawn(FW.rule_world, 1, "cpu", RULE_ARCHS, n_data=2, threads=1,
                 tmpdir=str(tmp_path_factory.mktemp("rule_grid")))


class _ReachedShardMap(Exception):
    """The reference's sharded layer got past its row rule."""


def _reference_row_rule(monkeypatch, arch, B, S, dp):
    """The reference's decision for ``row_capacity`` on ``B`` rows of ``S``
    tokens on a ``dp`` × 1 grid under the planner's context (tokens split
    over data where the batch divides, ``launch/shapes.py``): its
    ``_moe_apply_sharded`` raises its row rule's ``ValueError`` (returned
    here), or goes on to its ``shard_map`` (None)."""
    import types
    from repro.launch.dist import DistContext as JDistContext
    from repro.models import moe as jmoe

    def shard_map(f, mesh=None, in_specs=None, out_specs=None,
                  check_vma=True):
        raise _ReachedShardMap

    jcfg = jget_config(arch, reduced=True)
    E, d = jcfg.moe.num_experts, jcfg.d_model
    stub = types.SimpleNamespace(shape={"data": dp, "model": 1})
    jctx = JDistContext(mesh=stub, dp_axes=("data",),
                        tokens_dp_sharded=B % dp == 0)
    monkeypatch.setattr(jax, "shard_map", shard_map, raising=False)
    try:
        jmoe._moe_apply_sharded(
            {"router": jnp.zeros((d, E), jnp.float32)}, {},
            jnp.zeros((B * S, d), jnp.bfloat16), jcfg.moe,
            jmoe.moe_capacity(B * S, jcfg.moe), jctx, n_rows=B,
            row_capacity=1, dispatch="padded")
    except _ReachedShardMap:
        return None
    except ValueError as err:
        return str(err)
    raise AssertionError("the reference's layer neither raised nor reached "
                         "its shard_map")


@pytest.mark.parametrize("arch", RULE_ARCHS)
def test_families_outside_the_slice_raise(arch, rule_grid, monkeypatch):
    """Under a planner the paged entry points raise
    ``NotImplementedError`` before any collective, naming the reason (the
    reference's planner has no rule for a block pool, and its engine
    never runs under a planner), on these four stacks as on the others
    (Whisper's ahead of its decoder-only refusal). The per-row drop rule
    runs: on a 1 × 1 grid ``prefill`` and ``decode_step`` with
    ``row_capacity`` 1 give one process's counts exactly and its logits
    within ``SPEC_TOL`` (on Jamba the rule drops: its logits part from a
    run without it); so do 3 rows on a 2 × 1 grid, which do not split
    over data, so that every rank runs the rule on every row, as the
    reference's padded regime does there (its sharded layer goes past
    its row rule for those rows; on 4 rows, which split, too)."""
    import torch_families_worker as FW
    cfg = FW.rule_cfg(arch)
    ctx = DistContext(None, 0, 2, device="cpu", planner=SH.ShardingPlanner(
        cfg, SH.GridShape({"data": 1, "model": 2}, ("data", "model"))),
        batch=2)
    toks = torch.zeros((2, 4), dtype=torch.long)
    n = torch.full((2,), 4)
    table = torch.zeros((2, 1), dtype=torch.int32)
    calls = {
        "prefill_paged": lambda: MD.prefill_paged(
            {}, cfg, toks, {}, table, torch.zeros(2, dtype=torch.long), n),
        "decode_step_paged": lambda: MD.decode_step_paged(
            {}, cfg, toks[:, 0], n, {}, table, n, n)}
    for what, call in calls.items():
        with dist_ctx(ctx), pytest.raises(NotImplementedError) as err:
            call()
        assert "no rule for a block pool" in str(err.value), what
        assert "never runs under a planner" in str(err.value), what
    one_grid = DistContext(None, 0, 1, device="cpu")
    runs = [(FW.rule_serve(arch, None, 2), [FW.rule_serve(arch, one_grid,
                                                          2)])]
    runs.append((FW.rule_serve(arch, None, FW.ODD_B),
                 [r[arch] for r in rule_grid]))
    for one, got_all in runs:
        for got in got_all:
            assert got["group"] == slice(0, one["prefill"].shape[0])
            for a, b in zip(got["counts"], one["counts"]):
                for k in b:
                    assert torch.equal(a[k], b[k]), k
            for a, b in zip([got["prefill"]] + got["decode"],
                            [one["prefill"]] + one["decode"]):
                assert float((a - b).abs().max()) <= SPEC_TOL * float(
                    b.abs().max())
    if cfg.is_moe:
        free = FW.rule_serve(arch, None, 2, row_capacity=None)
        assert not torch.equal(free["prefill"], runs[0][0]["prefill"])
        for B in (FW.ODD_B, 4):
            assert _reference_row_rule(monkeypatch, arch, B, 16, 2) is None


def test_flash_decode_lse_plain_version():
    """Row 5's plain version with the log-sum-exp: o the same bits as
    without it and within a bf16 step of the reference's ``flash_decode``;
    lse equal to ``torch.logsumexp`` over the same masked logits, -inf on
    a row with no valid slot."""
    g = torch.Generator().manual_seed(3)
    B, S, H, Hkv, hd = 3, 40, 8, 2, 64
    q = torch.randn((B, H, hd), generator=g).bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=g).bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=g).bfloat16()
    valid = torch.rand((B, S), generator=g) > 0.3
    valid[2] = False
    o = ops.flash_decode(q, k, v, valid)
    o2, lse = ops.flash_decode(q, k, v, valid, lse=True)
    assert torch.equal(o, o2) and lse.dtype == torch.float32
    qg = q.float().reshape(B, Hkv, H // Hkv, hd)
    logits = torch.matmul(qg, k.float().permute(0, 2, 3, 1)) * hd ** -0.5
    logits = logits.masked_fill(~valid[:, None, None], float("-inf"))
    want = torch.logsumexp(logits, -1).reshape(B, H)
    assert torch.allclose(lse[:2], want[:2], rtol=0, atol=1e-5)
    assert torch.isinf(lse[2]).all() and (lse[2] < 0).all()
    jo = jflash_decode(jnp.asarray(q.float().numpy(), jnp.bfloat16),
                       jnp.asarray(k.float().numpy(), jnp.bfloat16),
                       jnp.asarray(v.float().numpy(), jnp.bfloat16),
                       jnp.asarray(valid.numpy()), interpret=True)
    np.testing.assert_allclose(o[:2].float().numpy(),
                               np.asarray(jo, np.float32)[:2], rtol=0,
                               atol=2 ** -7)


def test_combine_lse_matches_whole_attention():
    """Split a row's slots in two, attend over each with the lse output
    and combine by ``specs.combine_lse``'s rule: the attention over every
    slot within a bf16 step (the rule a cache cut over model uses)."""
    from repro_torch.models import specs as SP
    g = torch.Generator().manual_seed(4)
    B, S, H, Hkv, hd = 2, 32, 4, 2, 64
    q = torch.randn((B, H, hd), generator=g).bfloat16()
    k = torch.randn((B, S, Hkv, hd), generator=g).bfloat16()
    v = torch.randn((B, S, Hkv, hd), generator=g).bfloat16()
    valid = torch.ones((B, S), dtype=torch.bool)
    valid[1, 16:] = False
    whole = ops.flash_decode(q, k, v, valid)
    parts = [ops.flash_decode(q, k[:, s].contiguous(), v[:, s].contiguous(),
                              valid[:, s].contiguous(), lse=True)
             for s in (slice(0, 16), slice(16, 32))]

    def two_ranks(t, ctx, axis="model", dim=0):
        """An all-gather over two ranks, the second holding the last
        half's (o, lse)."""
        other = parts[1][0] if t.dtype == torch.bfloat16 else parts[1][1]
        return torch.cat([t, other[None]], dim=dim)

    orig = D.all_gather
    D.all_gather = two_ranks
    try:
        got = SP.combine_lse(parts[0][0], parts[0][1], None)
    finally:
        D.all_gather = orig
    assert float((got.float() - whole.float()).abs().max()) <= 2 ** -7
