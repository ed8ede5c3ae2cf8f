"""Training in the port against the reference, on the reduced granite
(2 layers, d 256, 4 experts top-2), weights built by
``repro.models.init_params`` and carried over by ``convert``; inputs drawn
with numpy from a seed and fed to both packages:

* ``SyntheticLMTask``'s arrays equal to the reference's;
* ``adamw_update``: moments and the metrics to float32 rounding, bf16
  parameters within one ulp, over steps through warmup, the cosine and
  clipping;
* ``forward_train``'s logits and router counts, ``loss_fn``'s terms, and
  the gradients leaf by leaf (relative L2), routing checked first;
* one ``make_train_step`` step with 1 and 2 microbatches, and
  ``train_loop``'s loss trajectory;
* checkpoints written by either package loaded by the other (parameters,
  the optimizer state, a quantized bank);
* ``python -m repro_torch.launch.train`` in process with ``--device cpu``;
* the kernels' refusal to run while autograd records a gradient, and
  ``forward_train(dispatch="ragged")``'s.
"""
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.core.ver import build_bank as jbuild_bank
from repro.models import forward_train as jforward_train
from repro.models import init_params as jinit_params
from repro.training import SyntheticLMTask as JSyntheticLMTask
from repro.training import TrainConfig as JTrainConfig
from repro.training import load_checkpoint as jload_checkpoint
from repro.training import loss_fn as jloss_fn
from repro.training import make_train_step as jmake_train_step
from repro.training import save_checkpoint as jsave_checkpoint
from repro.training import train_loop as jtrain_loop
from repro.training.adamw import AdamWConfig as JAdamWConfig
from repro.training.adamw import adamw_init as jadamw_init
from repro.training.adamw import adamw_update as jadamw_update
from repro.training.train import eval_perplexity as jeval_perplexity
from repro_torch.configs import get_config
from repro_torch.convert import (bank_from_reference, params_from_reference,
                                 params_to_reference, to_numpy)
from repro_torch.core import tree as T
from repro_torch.core.ver import build_bank
from repro_torch.kernels import ops
from repro_torch.launch import train as launch_train
from repro_torch.models.model import forward_train, init_params
from repro_torch.training import (AdamWConfig, SyntheticLMTask, TrainConfig,
                                  adamw_init, adamw_update, load_checkpoint,
                                  make_train_step, save_checkpoint,
                                  train_loop)
from repro_torch.training.train import _grads, to_batch
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
#: Logits of the two packages on this two-layer stack agree to this where
#: routing agrees (bf16 projections rounded in each library's order; the
#: engine suite's bound).
LOGIT_TOL = 0.05
#: Loss terms agree to this relative error (float32 reductions over bf16
#: logits in another order).
LOSS_RTOL = 1e-4
#: Per-leaf relative L2 error of the gradients. Both packages' bf16
#: gradients sit ~10-14% (relative L2) from a float32 forward's; they agree
#: with each other to ~1.6% (bf16 rounding of the logits' gradient,
#: amplified by cancellation in the sums).
GRAD_RTOL = 0.05
#: After one step from the same weights, the parameters' update (new - old)
#: agrees to this relative L2 error: Adam's first step is ~lr · sign(g), so
#: a gradient element near 0 whose sign differs moves by 2 lr.
UPDATE_RTOL = 0.25
_WEIGHTS = {}


def _weights():
    """(reference config, port config, reference params (jax), reference
    params as numpy), built once per module."""
    if not _WEIGHTS:
        jcfg = jget_config(ARCH, reduced=True)
        jp = jinit_params(jax.random.PRNGKey(0), jcfg)
        _WEIGHTS["w"] = (jcfg, get_config(ARCH, reduced=True), jp,
                         jax.tree_util.tree_map(np.asarray, jp))
    return _WEIGHTS["w"]


def _from_port(tree):
    """The port's tensors → jax arrays through ``params_to_reference``
    (bf16 bit for bit)."""
    def leaf(a):
        return jnp.asarray(a.view(jnp.bfloat16) if a.dtype == np.uint16
                           else a)
    return jax.tree_util.tree_map(leaf, params_to_reference(tree))


def _batch(vocab, B=4, S=33, seed=0):
    return next(SyntheticLMTask(vocab, seed=seed).batches(B, S, 1, seed=seed))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def test_synthetic_task_matches_reference():
    for vocab, seed in ((512, 0), (49155, 3)):
        a, b = JSyntheticLMTask(vocab, seed=seed), SyntheticLMTask(vocab,
                                                                    seed=seed)
        assert np.array_equal(a.table, b.table)
        assert np.array_equal(a.sample(5, 17, seed=7), b.sample(5, 17, seed=7))
        for x, y in zip(a.batches(3, 9, 3, seed=11), b.batches(3, 9, 3,
                                                               seed=11)):
            assert x.keys() == y.keys()
            for k in x:
                assert x[k].dtype == y[k].dtype
                assert np.array_equal(x[k], y[k])


def test_adamw_update_matches_reference():
    """Six steps through warmup and the cosine, alternating clipped
    (gnorm ≈ 60) and unclipped gradients: the learning rate and gnorm to
    float32 rounding (relative 1e-6), the moments to 1e-6 of their largest
    magnitude, bf16 parameters within one ulp, float32 ones to 1e-6."""
    rng = np.random.default_rng(0)

    def tree(scale):
        return {"w": (rng.standard_normal((3, 16, 8)) * scale)
                .astype(jnp.bfloat16),
                "n": {"s": (rng.standard_normal((16,)) * scale)
                      .astype(np.float32)}}

    start = tree(0.5)
    jp = jax.tree_util.tree_map(jnp.asarray, start)
    p = params_from_reference(start)
    jcfg, cfg = JAdamWConfig(warmup_steps=2, total_steps=6), \
        AdamWConfig(warmup_steps=2, total_steps=6)
    js, ts = jadamw_init(jp), adamw_init(p)
    assert int(ts["step"]) == 0 and ts["step"].dtype == torch.int32
    for i in range(6):
        g = tree(0.3 if i % 2 else 3.0)
        jp, js, jm = jadamw_update(jcfg, jp, jax.tree_util.tree_map(
            jnp.asarray, g), js)
        p, ts, tm = adamw_update(cfg, p, params_from_reference(g), ts)
        for k in ("gnorm", "lr"):
            assert abs(float(tm[k]) - float(jm[k])) <= 1e-6 * abs(
                float(jm[k])), (i, k)
        for name in ("m", "v"):
            for a, b in zip(jax.tree_util.tree_leaves(js[name]),
                            T.leaves(ts[name])):
                a = np.asarray(a)
                assert np.abs(b.numpy() - a).max() <= \
                    1e-6 * np.abs(a).max(), (i, name)
        assert int(ts["step"]) == int(js["step"]) == i + 1
        ulps = np.abs(np.asarray(jp["w"]).view(np.uint16).astype(np.int32) -
                      to_numpy(p["w"]).astype(np.int32))
        assert ulps.max() <= 1, i
        np.testing.assert_allclose(p["n"]["s"].numpy(),
                                   np.asarray(jp["n"]["s"]), rtol=1e-6,
                                   atol=1e-6)


def _forward_pair(capacity_factor=None):
    jcfg, cfg, jp, npp = _weights()
    b = _batch(cfg.vocab_size)
    jl, jaux = jforward_train(jp, jcfg, {"tokens": jnp.asarray(b["tokens"])},
                              capacity_factor=capacity_factor)
    tl, taux = forward_train(params_from_reference(npp), cfg,
                             to_batch({"tokens": b["tokens"]}, "cpu"),
                             capacity_factor=capacity_factor)
    return jl, jaux, tl, taux


def test_forward_train_matches_reference():
    """Routing first (the counts of every layer equal), then the logits
    within LOGIT_TOL, the load-balance loss to float32 rounding; remat
    changes nothing."""
    jl, jaux, tl, taux = _forward_pair()
    assert tl.dtype == torch.float32 and tl.shape == jl.shape
    assert taux["counts"].keys() == jaux["counts"].keys()
    for k in jaux["counts"]:
        assert np.array_equal(taux["counts"][k].numpy(),
                              np.asarray(jaux["counts"][k])), k
    assert np.abs(tl.numpy() - np.asarray(jl)).max() <= LOGIT_TOL
    assert abs(float(taux["aux_loss"]) - float(jaux["aux_loss"])) <= \
        LOSS_RTOL * float(jaux["aux_loss"])
    jcfg, cfg, jp, npp = _weights()
    tl2, _ = forward_train(params_from_reference(npp), cfg,
                           to_batch({"tokens": _batch(cfg.vocab_size)
                                     ["tokens"]}, "cpu"), remat=False)
    assert torch.equal(tl, tl2)


def test_loss_and_gradients_match_reference():
    """``loss_fn``'s terms (ce, aux, z) to LOSS_RTOL and every gradient
    leaf, in the reference's flatten order, within GRAD_RTOL relative L2;
    every gradient finite and no leaf without one."""
    jcfg, cfg, jp, npp = _weights()
    b = _batch(cfg.vocab_size)
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    (jt, jm), jg = jax.value_and_grad(
        lambda q: jloss_fn(q, jcfg, jb, JTrainConfig()), has_aux=True)(jp)
    p = params_from_reference(npp)
    loss, m, grads = _grads(p, cfg, to_batch(b, "cpu"), TrainConfig())
    for k in jaux_keys(jm):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(loss), float(jt), rtol=LOSS_RTOL)
    jflat = jax.tree_util.tree_flatten_with_path(jg)[0]
    paths = T.flatten(p)[0]
    assert len(jflat) == len(grads) == len(paths)
    for (jpath, ja), path, g in zip(jflat, paths, grads):
        assert jax.tree_util.keystr(jpath).replace("']['", "/") \
            .strip("[']") == path
        assert g.dtype == T.leaves(p)[paths.index(path)].dtype
        assert bool(torch.isfinite(g).all()), path
        assert _rel_l2(g.float().numpy(), np.asarray(ja, np.float32)) <= \
            GRAD_RTOL, path


def jaux_keys(m):
    return [k for k in ("ce", "aux", "z") if k in m]


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_reference(microbatches):
    """One step of ``make_train_step`` from the same weights and batch:
    the loss and ce to LOSS_RTOL (mean over microbatches with 2), aux and
    z with 1 (the reference's metrics hold only "ce" under microbatches),
    gnorm within GRAD_RTOL, lr exact, the parameters' update within
    UPDATE_RTOL relative L2 per leaf, every parameter in its dtype."""
    jcfg, cfg, jp, npp = _weights()
    b = _batch(cfg.vocab_size, B=4)
    jt = JTrainConfig(optimizer=JAdamWConfig(lr=1e-3),
                      microbatches=microbatches)
    tt = TrainConfig(optimizer=AdamWConfig(lr=1e-3),
                     microbatches=microbatches)
    jp2, js2, jm = jax.jit(jmake_train_step(jcfg, jt))(
        jp, jadamw_init(jp), {k: jnp.asarray(v) for k, v in b.items()})
    p = params_from_reference(npp)
    p2, s2, m = make_train_step(cfg, tt)(p, adamw_init(p), to_batch(b, "cpu"))
    assert set(m) == set(jm)
    for k in ("loss", "ce", "aux", "z"):
        if k in jm:
            np.testing.assert_allclose(float(m[k]), float(jm[k]),
                                       rtol=LOSS_RTOL, err_msg=k)
    np.testing.assert_allclose(float(m["gnorm"]), float(jm["gnorm"]),
                               rtol=GRAD_RTOL)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-7)
    assert int(s2["step"]) == 1
    old = T.leaves(p)
    for (jpath, ja), a0, a1 in zip(
            jax.tree_util.tree_flatten_with_path(jp2)[0], old, T.leaves(p2)):
        assert a1.dtype == a0.dtype and a1.shape == a0.shape
        want = np.asarray(ja, np.float32) - a0.float().numpy()
        got = (a1.float() - a0.float()).numpy()
        assert _rel_l2(got, want) <= UPDATE_RTOL, jax.tree_util.keystr(jpath)


def test_train_loop_trajectory_matches_reference():
    """Five steps of ``train_loop`` in both packages on the same batches:
    every logged loss within 1e-3 relative (bf16 updates drift apart a
    little each step), the loss falling, the history's keys and steps the
    reference's; ``steps`` one entry per step, with its loss."""
    jcfg, cfg, jp, npp = _weights()
    task = SyntheticLMTask(cfg.vocab_size, seed=0)
    tcfg = TrainConfig(optimizer=AdamWConfig(lr=2e-3, warmup_steps=2,
                                             total_steps=5))
    jtcfg = JTrainConfig(optimizer=JAdamWConfig(lr=2e-3, warmup_steps=2,
                                                total_steps=5))
    jlog, tlog, steps = [], [], []
    _, _, jh = jtrain_loop(jcfg, jp, task.batches(8, 33, 5), jtcfg,
                           log_every=1, log=jlog.append)
    _, _, th = train_loop(cfg, params_from_reference(npp),
                          task.batches(8, 33, 5), tcfg, log_every=1,
                          log=tlog.append, steps=steps)
    assert [s["step"] for s in steps] == list(range(5))
    assert all(s["ms"] > 0 for s in steps)
    assert [s["loss"] for s in steps if s["step"] in (0, 1, 2, 3, 4)] == \
        [h["loss"] for h in th]
    assert [h["step"] for h in th] == [h["step"] for h in jh]
    for a, b in zip(th, jh):
        assert set(a) == set(b)
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-3)
    assert th[-1]["loss"] < th[0]["loss"]
    assert [line.split("  ")[0] for line in tlog] == \
        [line.split("  ")[0] for line in jlog]


def test_train_loop_logs_without_aux_under_microbatches():
    """The reference's loop reads ``m['aux']``, which its microbatched
    step does not return (a KeyError); the port's logs the line without
    it."""
    jcfg, cfg, jp, npp = _weights()
    task = SyntheticLMTask(cfg.vocab_size, seed=0)
    with pytest.raises(KeyError, match="aux"):
        jtrain_loop(jcfg, jp, task.batches(4, 17, 1),
                    JTrainConfig(microbatches=2), log=lambda s: None)
    lines = []
    _, _, h = train_loop(cfg, params_from_reference(npp),
                         task.batches(4, 17, 2), TrainConfig(microbatches=2),
                         log=lines.append)
    assert "aux" not in h[0] and len(lines) == 2
    assert "aux" not in lines[0] and "gnorm" in lines[0]


def test_checkpoints_load_across_packages(tmp_path):
    """Parameters and the optimizer state, and a quantized bank, written
    by either package and read by the other: every leaf bit for bit, the
    manifest's n_leaves, step and dtypes the reference's, the port's key
    paths in place of the treedef."""
    jcfg, cfg, jp, npp = _weights()
    p = params_from_reference(npp)
    s = adamw_init(p)
    s["m"] = T.tree_map(lambda t: torch.randn(t.shape), s["m"])
    s["step"] = s["step"] + 3
    tree = {"params": p, "opt": s}
    like_j = {"params": jp, "opt": jadamw_init(jp)}
    port_dir, ref_dir = str(tmp_path / "port"), str(tmp_path / "ref")
    save_checkpoint(port_dir, tree, step=7)
    got, step = jload_checkpoint(port_dir, like_j)
    assert step == 7
    jsave_checkpoint(ref_dir, got, step=7)
    with open(os.path.join(port_dir, "manifest.json")) as f:
        mp = json.load(f)
    with open(os.path.join(ref_dir, "manifest.json")) as f:
        mr = json.load(f)
    assert (mp["n_leaves"], mp["step"], mp["dtypes"]) == \
        (mr["n_leaves"], mr["step"], mr["dtypes"])
    assert len(mp["paths"]) == mp["n_leaves"] and "treedef" in mr
    for a, b in zip(T.leaves(tree), jax.tree_util.tree_leaves(got)):
        assert a.dtype != torch.bfloat16 or b.dtype == jnp.bfloat16
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
    back, step = load_checkpoint(ref_dir, tree)
    assert step == 7
    for a, b in zip(T.leaves(tree), T.leaves(back)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # A quantized bank: QuantizedTensor and ExpertBankQ leaves in the
    # reference's flatten order.
    jbank = jbuild_bank(jp["blocks"]["0"]["moe"]["experts"], n_hi=2,
                        lo_bits=4)
    bank = bank_from_reference(jax.tree_util.tree_map(np.asarray, jbank))
    assert T.flatten(bank)[0][:2] == ["lo.w_down/packed", "lo.w_down/scales"]
    jsave_checkpoint(str(tmp_path / "jbank"), jbank)
    tb, _ = load_checkpoint(str(tmp_path / "jbank"), bank)
    save_checkpoint(str(tmp_path / "tbank"), tb)
    jb2, _ = jload_checkpoint(str(tmp_path / "tbank"), jbank)
    for a, b, c in zip(T.leaves(bank), T.leaves(tb),
                       jax.tree_util.tree_leaves(jb2)):
        assert torch.equal(a, b)
        assert np.array_equal(np.asarray(c).astype(np.float32),
                              a.float().numpy())
    with pytest.raises(ValueError, match="leaves"):
        load_checkpoint(port_dir, p)


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch.launch.train`` in process with ``--device
    cpu``: the reference's [train] lines, the history, a falling loss, a
    finite held-out perplexity, a checkpoint the reference loads; the
    audio and VLM families refused as the reference's launcher refuses
    them."""
    ckpt = str(tmp_path / "ck")
    out = launch_train.main(["--steps", "6", "--batch", "4", "--seq", "33",
                             "--device", "cpu", "--ckpt", ckpt])
    printed = capsys.readouterr().out.splitlines()
    assert printed == out["lines"]
    assert out["lines"][0].startswith(f"[train] {out['cfg'].name}: ")
    assert out["lines"][-2].startswith("[train] final loss ")
    assert out["lines"][-1] == f"[train] checkpoint → {ckpt}"
    assert [h["step"] for h in out["history"]] == [0, 1, 2, 3, 4, 5]
    assert out["history"][-1]["loss"] < out["history"][0]["loss"]
    assert np.isfinite(out["ppl"]) and len(out["steps"]) == 6
    jcfg, _, jp, _ = _weights()
    restored, step = jload_checkpoint(ckpt, jp)
    assert step == 6
    handed = _from_port(out["params"])
    for a, b, c in zip(T.leaves(out["params"]),
                       jax.tree_util.tree_leaves(restored),
                       jax.tree_util.tree_leaves(handed)):
        assert np.array_equal(a.float().numpy(), np.asarray(b, np.float32))
        assert b.dtype == c.dtype and np.array_equal(np.asarray(b),
                                                     np.asarray(c))
    # The reference's held-out perplexity of the port's trained weights
    # (its padded layout) against the port's (the ragged layout's plain
    # versions): within 1e-3 relative.
    task = SyntheticLMTask(jcfg.vocab_size, seed=0)
    want = jeval_perplexity(jcfg, handed, task.batches(4, 33, 3, seed=9999))
    np.testing.assert_allclose(out["ppl"], want, rtol=1e-3)
    for arch in ("whisper-tiny", "llava-next-34b"):
        with pytest.raises(SystemExit, match="LM-only"):
            launch_train.main(["--arch", arch, "--device", "cpu"])


def _kernel_calls(cfg, params):
    """Each kernel wrapper on small CPU inputs derived from the reduced
    granite's experts, as name → call(requires_grad)."""
    E, d, F = cfg.moe.num_experts, cfg.d_model, cfg.moe.d_ff_expert
    experts = {k: v[0] for k, v in params["blocks"]["0"]["moe"]["experts"]
               .items()}
    bank = build_bank({k: v[None] for k, v in experts.items()}, n_hi=1,
                      lo_bits=4).layer(0)
    tile_eid = torch.zeros(2, dtype=torch.int32)
    tile_slot = torch.full((2,), -1, dtype=torch.int32)
    n_tiles = torch.ones(1, dtype=torch.int32)
    lo = bank.lo

    def x(shape, grad):
        return torch.randn(shape).to(torch.bfloat16).requires_grad_(grad)

    def dense(grad):
        return {k: v.detach().clone().requires_grad_(grad)
                for k, v in experts.items()}

    q = torch.randn(2, 4, 64).to(torch.bfloat16)
    return {
        "ragged_quant_ffn": lambda g: ops.ragged_quant_ffn(
            x((16, d), g), tile_eid, tile_slot, n_tiles, lo, None, bits=4,
            group=64, bm=8),
        "ragged_dense_ffn": lambda g: ops.ragged_dense_ffn(
            x((16, d), False), tile_eid, n_tiles, dense(g), bm=8),
        "grouped_lo_matmul": lambda g: ops.grouped_lo_matmul(
            x((E, 8, d), g), lo["w_gate"].packed, lo["w_gate"].scales, 4,
            64),
        "flash_decode": lambda g: ops.flash_decode(
            q.clone().requires_grad_(g), torch.zeros(2, 32, 2, 64,
                                                     dtype=torch.bfloat16),
            torch.zeros(2, 32, 2, 64, dtype=torch.bfloat16),
            torch.ones(2, 32, dtype=torch.bool)),
    }


@pytest.mark.parametrize("name", ["ragged_quant_ffn", "ragged_dense_ffn",
                                  "grouped_lo_matmul", "flash_decode"])
def test_kernel_wrappers_refuse_inputs_that_require_grad(name):
    """A kernel's output would carry no ``grad_fn``: a wrapper raises while
    autograd records and an input requires a gradient, and runs under
    ``torch.no_grad()`` or on inputs that require none."""
    _, cfg, _, npp = _weights()
    call = _kernel_calls(cfg, params_from_reference(npp))[name]
    with pytest.raises(RuntimeError, match="no backward"):
        call(True)
    with torch.no_grad():
        call(True)
    call(False)


def test_forward_train_ragged_refused_under_grad():
    """``forward_train(dispatch="ragged")`` raises while parameters require
    gradients and autograd records; under ``torch.no_grad()`` it runs the
    ragged layout and agrees with the padded one, and the padded one is
    differentiable (every expert gets a gradient)."""
    _, cfg, _, npp = _weights()
    p = T.tree_map(lambda t: t.requires_grad_(True),
                   params_from_reference(npp))
    batch = to_batch({"tokens": _batch(cfg.vocab_size)["tokens"]}, "cpu")
    with pytest.raises(RuntimeError, match="no backward"):
        forward_train(p, cfg, batch, dispatch="ragged")
    with torch.no_grad():
        rag, ra = forward_train(p, cfg, batch, dispatch="ragged",
                                capacity_factor=8.0)
        pad, pa = forward_train(p, cfg, batch, dispatch="padded",
                                capacity_factor=8.0)
    assert torch.equal(ra["counts"]["0"], pa["counts"]["0"])
    assert (rag - pad).abs().max() <= LOGIT_TOL
    logits, _ = forward_train(p, cfg, batch)
    logits.sum().backward()
    w = p["blocks"]["0"]["moe"]["experts"]["w_gate"]
    assert w.grad is not None and bool((w.grad.abs().sum(dim=(2, 3)) > 0)
                                       .any())


def test_init_on_the_cpu_trains_every_leaf():
    """A step on the port's own seeded weights gives every leaf a finite
    gradient and moves every weight (not the norms' scales: at 1.0 a bf16
    step is 2^-8, above the first step's lr of 2e-4)."""
    cfg = get_config(ARCH, reduced=True)
    p = init_params(cfg, device="cpu")
    b = to_batch(_batch(cfg.vocab_size), "cpu")
    _, _, grads = _grads(p, cfg, b, TrainConfig())
    for path, g in zip(T.flatten(p)[0], grads):
        assert bool(torch.isfinite(g).all()), path
    p2, _, m = make_train_step(cfg, TrainConfig())(p, adamw_init(p), b)
    assert np.isfinite(float(m["loss"])) and np.isfinite(float(m["gnorm"]))
    for path, a, b in zip(T.flatten(p)[0], T.leaves(p), T.leaves(p2)):
        if not path.endswith("scale"):
            assert not torch.equal(a, b), path
