"""Quality at budget (the paper's Table 4, as the reference's
``benchmarks/quality.py`` computes it) in the port against the reference:
the reduced granite trained briefly by the reference's ``train_loop``, its
weights carried over by ``convert``, then held-out perplexity under the
four expert banks of the benchmark — fp16 (the dense experts), static
int4, static int2, and int2 lo with a hot bf16 quarter chosen from router
counts — by both packages. The port's banks come from
``repro_torch.training.quality`` (its ``bank_with_hotset`` and
``hotness_from_counts``), the reference's from
``benchmarks/quality_common.py``; the port evaluates on both MoE layouts
(the ragged kernels' plain versions, and the padded layout's grouped
GEMM), the reference on its CPU default (padded)."""
import jax
import numpy as np
import pytest
import torch

from benchmarks.quality_common import bank_with_hotset as jbank_with_hotset
from benchmarks.quality_common import hotness_from_counts as jhotness
from benchmarks.quality_common import ppl as jppl
from repro.configs import get_config as jget_config
from repro.models import init_params as jinit_params
from repro.training import SyntheticLMTask as JSyntheticLMTask
from repro.training import TrainConfig as JTrainConfig
from repro.training import train_loop as jtrain_loop
from repro.training.adamw import AdamWConfig as JAdamWConfig
from repro_torch.configs import get_config
from repro_torch.convert import bank_from_reference, params_from_reference
from repro_torch.training.quality import (bank_with_hotset, hot_sets,
                                          hotness_from_counts)
from repro_torch.training.train import eval_perplexity
from torch_threads import _one_thread  # noqa: F401

ARCH = "granite-moe-1b-a400m"
TRAIN_STEPS = 40
#: The benchmark's evaluation capacity (``quality_common.ppl``): no drops.
CAPACITY = 8.0
#: The port's perplexities against the reference's, relative (bf16
#: logits rounded in each library's order; ~1e-4 seen).
PPL_RTOL = 2e-3
#: Router counts may differ by near-tie swaps: at most this share of a
#: layer's assignments (~1 in 1536 seen).
SWAP_SHARE = 1 / 256
_MODEL = {}


def _eval(task, n=4, batch=8, length=33, seed=777):
    """The benchmark's held-out batches (``benchmarks.common.eval_batches``
    at this test's length)."""
    for i in range(n):
        toks = task.sample(batch, length, seed=seed + i)
        yield {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _model():
    """(reference config, port config, trained reference params, the same
    in the port, the task), trained once per module."""
    if not _MODEL:
        jcfg = jget_config(ARCH, reduced=True)
        task = JSyntheticLMTask(jcfg.vocab_size, seed=0)
        tcfg = JTrainConfig(optimizer=JAdamWConfig(
            lr=2e-3, warmup_steps=5, total_steps=TRAIN_STEPS))
        jp, _, hist = jtrain_loop(jcfg, jinit_params(jax.random.PRNGKey(0),
                                                     jcfg),
                                  task.batches(8, 33, TRAIN_STEPS), tcfg,
                                  log_every=TRAIN_STEPS, log=lambda *_: None)
        assert hist[-1]["loss"] < hist[0]["loss"]
        p = params_from_reference(jax.tree_util.tree_map(np.asarray, jp))
        _MODEL["m"] = (jcfg, get_config(ARCH, reduced=True), jp, p, task)
    return _MODEL["m"]


def test_hotness_and_hot_sets_match_reference():
    """Router counts over the evaluation workload agree with the
    reference's per layer: the same total, and apart from router near
    ties (an assignment moved from one expert to another by a rounding;
    ROADMAP's parity hazards) equal: at most SWAP_SHARE of a layer's
    assignments moved. The hot quarters chosen from them are the
    reference's."""
    jcfg, cfg, jp, p, task = _model()
    want = np.asarray(jhotness(jcfg, jp, _eval(task, n=3)))
    for dispatch in ("ragged", "padded"):
        got = hotness_from_counts(cfg, p, _eval(task, n=3),
                                  dispatch=dispatch)
        assert np.array_equal(got.sum(-1), want.sum(-1)), dispatch
        moved = np.abs(got - want).sum(-1) / 2
        assert (moved <= SWAP_SHARE * want.sum(-1)).all(), (dispatch, moved)
    n_hi = cfg.moe.num_experts // 4
    assert hot_sets(got, n_hi) == [
        [int(e) for e in np.argsort(-np.asarray(want)[l])[:n_hi]]
        for l in range(cfg.n_layers)]


def test_bank_with_hotset_matches_reference():
    """The port's ``bank_with_hotset`` builds the reference's bank leaf for
    leaf: lo codes and scales, the published hi slots and both maps."""
    jcfg, cfg, jp, p, task = _model()
    hs = [[1], [2]]
    want = bank_from_reference(jax.tree_util.tree_map(
        np.asarray, jbank_with_hotset(jp, lo_bits=2, hi_sets=hs)))
    got = bank_with_hotset(p, lo_bits=2, hi_sets=hs)
    for n in want.lo:
        assert torch.equal(got.lo[n].packed, want.lo[n].packed), n
        assert torch.equal(got.lo[n].scales, want.lo[n].scales), n
        assert torch.equal(got.hi[n], want.hi[n]), n
    assert torch.equal(got.slot_map, want.slot_map)
    assert torch.equal(got.slot_owner, want.slot_owner)


@pytest.mark.parametrize("dispatch", ["ragged", "padded"])
def test_perplexity_under_the_four_banks_matches_reference(dispatch):
    """fp16, static int4, static int2 and int2 lo + a hot bf16 quarter:
    each perplexity within PPL_RTOL of the reference's. (The briefly
    trained model sits near the uniform perplexity, where the four banks
    differ by less than the bf16 noise: their order is not held here.)"""
    jcfg, cfg, jp, p, task = _model()
    L, E = cfg.n_layers, cfg.moe.num_experts
    hot = jhotness(jcfg, jp, _eval(task, n=3))
    hs = hot_sets(np.asarray(hot), E // 4)
    empty = [[] for _ in range(L)]
    banks = {"fp16": (None, None),
             "int4": ((4, empty), (4, empty)),
             "int2": ((2, empty), (2, empty)),
             "int2+hot": ((2, hs), (2, hs))}
    got, want = {}, {}
    for name, (jb, tb) in banks.items():
        want[name] = jppl(jcfg, jp, _eval(task), None if jb is None else
                          jbank_with_hotset(jp, lo_bits=jb[0],
                                            hi_sets=jb[1]))
        bank = None if tb is None else {"0": bank_with_hotset(
            p, lo_bits=tb[0], hi_sets=tb[1])}
        got[name] = eval_perplexity(cfg, p, _eval(task),
                                    capacity_factor=CAPACITY, bank=bank,
                                    dispatch=dispatch)
        np.testing.assert_allclose(got[name], want[name], rtol=PPL_RTOL,
                                   err_msg=name)
        assert np.isfinite(got[name])
    assert got["int2"] != got["fp16"]
