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

The recurrent families (``falcon-mamba-7b``'s SSM state, ``recurrentgemma-2b``'s
RG-LRU state and attention ring) must emit, request by request, the tokens
of a one-request greedy decode through JAX's ``lm_decode_step`` from a zero
state — the JAX engine's own tokens differ, since its prefill feeds the
state the bucket's padding (ROADMAP.md C) — with more requests than slots,
prompts that do not fill the bucket and, for rglru, positions past the
window.  The encoder-decoder family is refused.
"""
import jax
import jax.numpy as jnp
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
    kw = dict(slots=2, max_len=64, greedy=greedy, temperature=0.7, seed=4)
    want = _serve(JServingEngine(japi, jp, JServeConfig(prefill_bucket=16, **kw)),
                  JRequest, prompts, 6)
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
    got = _serve(ServingEngine(api, tp, ServeConfig(slots=2, max_len=32)),
                 Request, prompts, 3)
    assert sorted(got) == list(range(7)) and all(len(g) == 3 for g in got.values())
    for i, p in enumerate(prompts):
        assert got[i] == _reference_generate(api, tp, p, 3, max_len=32)


def test_eos_stops_early(lms):
    _, _, api, tp = lms
    prompt = _prompts(5, 1, 4, 5)[0]
    first = _serve(ServingEngine(api, tp, ServeConfig(slots=1, max_len=32)),
                   Request, [prompt], 4)[0][0]
    engine = ServingEngine(api, tp, ServeConfig(slots=1, max_len=32))
    engine.submit(Request(uid=0, prompt=prompt, max_new_tokens=10, eos_id=first))
    out = engine.run()[0]
    assert len(out.generated) < 10 and out.generated[-1] == first


@pytest.fixture(scope="module", params=["falcon-mamba-7b", "recurrentgemma-2b"])
def recurrent_lms(request):
    return _lms(request.param)


def _jax_generate(japi, jp, prompt, n_new, max_len):
    """Greedy decode of one request through JAX's ``lm_decode_step``, from a zero state."""
    cache = japi.init_cache(1, max_len)
    step = lambda cache, tok, t: japi.decode_step(jp, cache, jnp.asarray([[tok]], jnp.int32),
                                                  jnp.asarray(t, jnp.int32))
    for t, tok in enumerate(prompt):
        logits, cache = step(cache, int(tok), t)
    out = [int(jnp.argmax(logits[0, 0]))]
    while len(out) < n_new:
        logits, cache = step(cache, out[-1], len(prompt) + len(out) - 1)
        out.append(int(jnp.argmax(logits[0, 0])))
    return out


def test_recurrent_engine_generates_a_one_request_jax_decodes_tokens(recurrent_lms):
    japi, jp, api, tp = recurrent_lms
    prompts = _prompts(6, 5, 21, 37)            # the rglru smoke window is 32
    assert any(len(p) % 16 for p in prompts)
    engine = ServingEngine(api, tp, ServeConfig(slots=2, max_len=64))
    got = _serve(engine, Request, prompts, 6)
    assert sorted(got) == list(range(5)) and engine.prefills == 5
    for i, p in enumerate(prompts):
        assert got[i] == _jax_generate(japi, jp, p, 6, 64), i


def test_engine_refuses_the_encoder_decoder():
    api = get_model("seamless-m4t-medium", smoke=True, device="cpu")
    with pytest.raises(ValueError, match="encdec family is not served"):
        ServingEngine(api, api.init(0), ServeConfig(slots=2, max_len=32))


@pytest.mark.parametrize("length", [0, 32])
def test_engine_refuses_a_prompt_the_cache_cannot_hold(lms, length):
    _, _, api, tp = lms
    engine = ServingEngine(api, tp, ServeConfig(slots=1, max_len=32))
    with pytest.raises(ValueError, match="a prompt of"):
        engine.submit(Request(uid=0, prompt=np.ones(length, np.int32), max_new_tokens=2))
    assert not engine.queue
