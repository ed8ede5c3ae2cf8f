"""The port's sampler against the reference's (``repro.serving.sampler``):
the same float32 logits and parameters give the same probabilities, draws
and tokens, exactly; and a request's sampled tokens depend on its seed and
emission index only, never on the batch it shares."""
import numpy as np
import pytest

from repro.serving import sampler as jsampler
from repro_torch.configs import get_config
from repro_torch.models.model import init_params
from repro_torch.serving import sampler
from repro_torch.serving.backends import make_backend
from repro_torch.serving.engine import EngineConfig, InferenceEngine
from repro_torch.serving.requests import Request, make_prompts
from torch_threads import _one_thread  # noqa: F401

PARAMS = [dict(temperature=1.0), dict(temperature=0.7, top_k=5),
          dict(temperature=0.8, top_k=50, top_p=0.9),
          dict(temperature=1.3, top_p=0.5), dict(temperature=0.2, top_k=1),
          dict(temperature=2.0, top_k=300, top_p=0.99)]


def _logits(seed, V=257):
    rng = np.random.default_rng(seed)
    x = rng.normal(scale=3.0, size=V).astype(np.float32)
    x[rng.integers(0, V, 4)] = x.max()             # exact ties at the top
    return x


@pytest.mark.parametrize("kw", PARAMS, ids=lambda kw: "-".join(
    f"{k}{v}" for k, v in kw.items()))
def test_probs_draws_and_tokens_equal_reference(kw):
    sp, jsp = sampler.SamplingParams(seed=7, **kw), \
        jsampler.SamplingParams(seed=7, **kw)
    ours, ref = sampler.RequestSampler(sp), jsampler.RequestSampler(jsp)
    for seed in range(6):
        x = _logits(seed)
        p = sampler.sampling_probs(x, sp)
        assert np.array_equal(p, jsampler.sampling_probs(x, jsp))
        for u in (0.0, 0.3, 0.999999, 1e-9):
            assert sampler.categorical(p, u) == jsampler.categorical(p, u)
        for t in range(4):
            assert ours.next_token(x, t) == ref.next_token(x, t)


def test_counter_uniform_equals_reference():
    for seed in (0, 1, 2 ** 40 + 3, -5):
        for stream in range(4):
            for a in (0, 1, 31, 10 ** 6):
                for b in (0, 2):
                    assert sampler.counter_uniform(seed, stream, a, b) == \
                        jsampler.counter_uniform(seed, stream, a, b)


def test_greedy_is_exact_argmax():
    x = _logits(3)
    for s in (sampler.RequestSampler(), sampler.RequestSampler(
            sampler.SamplingParams(temperature=0.0, top_k=3, seed=9))):
        assert s.greedy
        assert s.next_token(x, 5) == int(np.argmax(x))
    with pytest.raises(ValueError):
        sampler.sampling_probs(x, sampler.GREEDY)


@pytest.mark.parametrize("bad", [
    dict(temperature=-0.1), dict(temperature=float("nan")),
    dict(temperature=float("inf")), dict(top_p=0.0), dict(top_p=1.5),
    dict(top_k=0), dict(top_k=2.5), dict(top_k=True), dict(seed=1.5),
    dict(seed=False)])
def test_validate_rejects_what_the_reference_rejects(bad):
    with pytest.raises(ValueError) as ours:
        sampler.SamplingParams(**bad).validate()
    with pytest.raises(ValueError) as ref:
        jsampler.SamplingParams(**bad).validate()
    assert str(ours.value) == str(ref.value)


ARCH = "granite-moe-1b-a400m"


def _serve(cfg, requests):
    """Tokens of ``requests`` served on a fresh engine (the backend takes
    the experts out of the parameters it is given)."""
    eng = InferenceEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                          make_backend("static", device="cpu"),
                          EngineConfig(max_slots=4, max_len=64,
                                       capacity_factor=8.0), device="cpu")
    handles = [eng.submit(r) for r in requests]
    eng.drain()
    return [list(h.tokens) for h in handles]


def test_seed_reproducible_across_batch_compositions():
    """The same request samples the same tokens alone and beside other
    traffic (drop-free capacity), and another seed gives other tokens."""
    cfg = get_config(ARCH, reduced=True)
    prompt = make_prompts("text", cfg.vocab_size, 1, 12, seed=5)[0]

    def target(seed):
        return Request(tokens=prompt, max_new_tokens=8,
                       sampling=sampler.SamplingParams(temperature=0.8,
                                                       seed=seed))

    others = [Request(tokens=make_prompts("math", cfg.vocab_size, 1, n,
                                          seed=n)[0], max_new_tokens=8,
                      sampling=sampler.SamplingParams(temperature=0.8,
                                                      seed=50 + n))
              for n in (9, 15)]
    alone = _serve(cfg, [target(1234)])[0]
    crowded = _serve(cfg, [others[0], target(1234), others[1]])[1]
    assert alone == crowded
    assert _serve(cfg, [target(1)])[0] != \
        _serve(cfg, [target(2)])[0]


def test_submit_rejects_bad_sampling_params():
    cfg = get_config(ARCH, reduced=True)
    eng = InferenceEngine(cfg, init_params(cfg, seed=0, device="cpu"),
                          make_backend("static", device="cpu"),
                          EngineConfig(max_slots=2, max_len=64),
                          device="cpu")
    with pytest.raises(ValueError, match="top_p"):
        eng.submit(Request(tokens=np.arange(5), sampling=sampler
                           .SamplingParams(temperature=1.0, top_p=0.0)))
    assert not eng.queue
