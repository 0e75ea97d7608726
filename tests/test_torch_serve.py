"""The port's serving engine against the JAX package's, on the CPU.

Both engines serve ``tinyllama-1.1b``'s smoke config on the same weights
(``interop.lm_params``) and the same prompts, mirroring ``tests/test_serve.py``:
the port's engine must emit the JAX engine's tokens — greedy, and sampled
from the same seed (the port draws ``jax.random.categorical``'s Gumbel noise
from its threefry copy) — and its own step-by-step greedy reference; slots
are reused when requests outnumber them, and EOS stops a request early.
The MoE smoke configs (``deepseek-v2-236b``: MLA's latent cache, a leading
dense layer; ``kimi-k2-1t-a32b``) must emit the JAX engine's tokens too:
the port's batched step routes all slots' tokens at capacity = slots, the
JAX engine's vmapped step each slot at capacity 1.
"""
import jax
import numpy as np
import pytest
import torch

from repro.models.registry import get_model as j_get_model
from repro.serve.engine import Request as JRequest
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.engine import ServingEngine as JServingEngine
from repro_torch import interop
from repro_torch.models.registry import get_model
from repro_torch.serve.engine import Request, ServeConfig, ServingEngine


def _lms(arch):
    japi = j_get_model(arch, smoke=True)
    jp = japi.init(jax.random.PRNGKey(0))
    api = get_model(arch, smoke=True, device="cpu")
    return japi, jp, api, interop.lm_params(jax.tree.map(np.asarray, jp), api.cfg, "cpu")


@pytest.fixture(scope="module")
def lms():
    return _lms("tinyllama-1.1b")


def _serve(engine, request_cls, prompts, max_new):
    for i, p in enumerate(prompts):
        engine.submit(request_cls(uid=i, prompt=p, max_new_tokens=max_new))
    return {r.uid: r.generated for r in engine.run()}


def _prompts(seed, n, lo=3, hi=9):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, 100, int(rng.integers(lo, hi))).astype(np.int32) for _ in range(n)]


@pytest.fixture(scope="module", params=["deepseek-v2-236b", "kimi-k2-1t-a32b"])
def moe_lms(request):
    return _lms(request.param)


@pytest.mark.parametrize("greedy", [True, False])
def test_engine_generates_the_jax_engines_tokens(lms, greedy):
    _same_tokens(*lms, greedy)


@pytest.mark.parametrize("greedy", [True, False])
def test_moe_engine_generates_the_jax_engines_tokens(moe_lms, greedy):
    _same_tokens(*moe_lms, greedy)


def _same_tokens(japi, jp, api, tp, greedy):
    prompts = _prompts(3, 5)
    kw = dict(slots=2, max_len=64, prefill_bucket=16, greedy=greedy, temperature=0.7, seed=4)
    want = _serve(JServingEngine(japi, jp, JServeConfig(**kw)), JRequest, prompts, 6)
    engine = ServingEngine(api, tp, ServeConfig(**kw))
    got = _serve(engine, Request, prompts, 6)
    assert got == want
    assert engine.prefills == len(prompts)


def _reference_generate(api, params, prompt, n_new, max_len=64):
    """Greedy decode of one request, straight through the model API."""
    cache = api.init_cache(1, max_len)
    for t, tok in enumerate(prompt):
        logits, cache = api.decode_step(params, cache, torch.tensor([[int(tok)]]), t)
    out = [int(torch.argmax(logits[0, 0]))]
    while len(out) < n_new:
        logits, cache = api.decode_step(params, cache, torch.tensor([[out[-1]]]),
                                        len(prompt) + len(out) - 1)
        out.append(int(torch.argmax(logits[0, 0])))
    return out


def test_engine_matches_reference_and_reuses_slots(lms):
    _, _, api, tp = lms
    prompts = _prompts(4, 7, 4, 5)
    got = _serve(ServingEngine(api, tp, ServeConfig(slots=2, max_len=32, prefill_bucket=8)),
                 Request, prompts, 3)
    assert sorted(got) == list(range(7)) and all(len(g) == 3 for g in got.values())
    for i, p in enumerate(prompts):
        assert got[i] == _reference_generate(api, tp, p, 3, max_len=32)


def test_eos_stops_early(lms):
    _, _, api, tp = lms
    prompt = _prompts(5, 1, 4, 5)[0]
    first = _serve(ServingEngine(api, tp, ServeConfig(slots=1, max_len=32, prefill_bucket=8)),
                   Request, [prompt], 4)[0][0]
    engine = ServingEngine(api, tp, ServeConfig(slots=1, max_len=32, prefill_bucket=8))
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=10, eos_id=first))
    out = engine.run()[0]
    assert len(out.generated) < 10 and out.generated[-1] == first
