"""The port's serving path against the JAX package's: greedy decode through
the serving engine on the setup of ``tests/test_serving.py``
(``test_decode_engine_matches_oracle``: reduced qwen3-14b, the JAX
model's weights from ``PRNGKey(0)``, a (2, 6) prompt, 4 new tokens).

Greedy tokens must be equal, so each test also reports the smallest top-2
logit margin of the steps it compares: a margin below the logits' error
would make equality luck, and the test says so instead of passing.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_config
from repro.launch.serve import decode_loop as jax_decode_loop
from repro.launch.serve import decode_loop_engine as jax_decode_loop_engine
from repro.launch.steps import make_serve_step as jax_make_serve_step
from repro_torch.configs import get_config
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve as S
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.serving import ReadyHandle, Request, ServingEngine

PROMPT_LEN, GEN = 6, 4
CACHE_SEQ = PROMPT_LEN + GEN


@pytest.fixture(scope="module")
def setup():
    jcfg = jax_config("qwen3-14b").reduced()
    jm, jstep = jax_make_serve_step(jcfg)
    jstep = jax.jit(jstep)
    jp = jm.init(jax.random.PRNGKey(0))
    prompt = np.asarray(np.random.default_rng(0).integers(
        0, jcfg.vocab_size, size=(2, PROMPT_LEN)), np.int32)
    ref = jax_decode_loop(jm, jstep, jp, prompt, gen=GEN, cache_seq=CACHE_SEQ)
    _, jsum = jax_decode_loop_engine(jm, jstep, jp, prompt, gen=GEN,
                                     cache_seq=CACHE_SEQ, prefetch=True)
    cfg = get_config("qwen3-14b").reduced()
    model, step = make_serve_step(cfg, "cpu")
    params = model_params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                     device="cpu")
    return dict(jm=jm, jstep=jstep, jp=jp, prompt=prompt, ref=ref, jsum=jsum,
                cfg=cfg, model=model, step=step, params=params)


def _min_margin(step, params, model, prompt):
    """Smallest top-2 logit margin over the generated steps (port)."""
    cache = model.init_cache(prompt.shape[0], CACHE_SEQ)
    tok = torch.from_numpy(prompt[:, :1])
    margins = []
    for t in range(PROMPT_LEN - 1 + GEN):
        if t < PROMPT_LEN:
            tok = torch.from_numpy(prompt[:, t:t + 1])
        nxt, logits, cache = step(params, {"token": tok, "pos": t,
                                           "cache": cache})
        if t >= PROMPT_LEN - 1:
            top2 = logits.topk(2, dim=-1).values
            margins.append(float((top2[:, 0] - top2[:, 1]).min()))
            tok = nxt[:, None]
    return min(margins)


def test_decode_loop_matches_jax(setup):
    s = setup
    got = S.decode_loop(s["model"], s["step"], s["params"], s["prompt"],
                        gen=GEN, cache_seq=CACHE_SEQ)
    margin = _min_margin(s["step"], s["params"], s["model"], s["prompt"])
    print(f"smallest top-2 logit margin over the generated steps: {margin:.3e}")
    # the logits agree with JAX's to 1e-4 (tests/test_torch_models.py), so
    # a tie closer than that would make token equality a coin toss
    assert margin > 1e-4, f"near-tie: top-2 margin {margin:.3e}"
    np.testing.assert_array_equal(got, s["ref"])
    assert got.dtype == np.int32 and got.shape == (2, GEN)


@pytest.mark.parametrize("prefetch", [False, True])
def test_engine_matches_decode_loop_and_jax(setup, prefetch):
    s = setup
    own = S.decode_loop(s["model"], s["step"], s["params"], s["prompt"],
                        gen=GEN, cache_seq=CACHE_SEQ)
    out, summary = S.decode_loop_engine(
        s["model"], s["step"], s["params"], s["prompt"], gen=GEN,
        cache_seq=CACHE_SEQ, prefetch=prefetch)
    np.testing.assert_array_equal(out, own)     # bit-identical to the loop
    np.testing.assert_array_equal(out, s["ref"])
    assert summary["requests"] == s["jsum"]["requests"] == PROMPT_LEN - 1 + GEN
    assert summary["mode"] == ("async" if prefetch else "sync")
    assert set(summary["per_tenant"]) == set(s["jsum"]["per_tenant"]) \
        == {"prefill", "decode"}
    for name, row in summary["per_tenant"].items():
        assert row["requests"] == s["jsum"]["per_tenant"][name]["requests"]
    assert summary["tokens"] == s["jsum"]["tokens"]


def test_teacher_forcing(setup):
    """Prefill's last-position logits equal the decode step's at the last
    prompt position (tests/test_models.py:77-105 in JAX), float32 1e-4."""
    s = setup
    _, prefill = make_prefill_step(s["cfg"], "cpu")
    toks = torch.from_numpy(s["prompt"])
    full, pcache = prefill(s["params"], {"tokens": toks,
                                         "cache_seq": CACHE_SEQ})
    cache = s["model"].init_cache(2, CACHE_SEQ)
    for t in range(PROMPT_LEN):
        _, logits, cache = s["step"](s["params"], {
            "token": toks[:, t:t + 1], "pos": t, "cache": cache})
    torch.testing.assert_close(logits, full, atol=1e-4, rtol=1e-4)
    torch.testing.assert_close(cache["k"][:, :, :PROMPT_LEN],
                               pcache["k"][:, :, :PROMPT_LEN],
                               atol=1e-4, rtol=1e-4)


def test_serve_main_on_the_cpu(capsys):
    out = S.main(["--arch", "qwen3-14b", "--reduce", "--device", "cpu",
                  "--batch", "2", "--prompt-len", "4", "--gen", "3"])
    assert out.shape == (2, 3)
    assert (out >= 0).all() and (out < 256).all()
    assert "tok/s" in capsys.readouterr().out


def test_model_init_is_seeded_with_the_reference_scales():
    cfg = get_config("qwen3-14b").reduced()
    model, _ = make_serve_step(cfg, "cpu")
    a, b, c = model.init(0), model.init(0), model.init(1)
    torch.testing.assert_close(a["stack"][1]["mlp"]["wd"],
                               b["stack"][1]["mlp"]["wd"], atol=0, rtol=0)
    assert not torch.equal(a["embed"], c["embed"])
    jp = jax_config("qwen3-14b").reduced()
    from repro.models.model import build_model as jax_build
    shapes = jax.tree.map(lambda x: x.shape[1:], jax.eval_shape(
        jax_build(jp).init, jax.random.PRNGKey(0))["stack"])
    for name, leaf in a["stack"][0]["attn"].items():
        assert tuple(leaf.shape) == shapes["attn"][name], name
    # std 1/sqrt(fan_in): wq (D, H, hd) has fan_in D = 64
    assert abs(float(a["stack"][0]["attn"]["wq"].std()) - 1 / 8) < 0.01
    assert abs(float(a["embed"].std()) - 0.02) < 0.002


def test_engine_sheds_and_refuses_a_tracer():
    class Src:
        obs = None

        def __init__(self):
            self.served = []

        def on_step(self, t):
            pass

        def next_request(self, t):
            return Request(tenant="a" if t % 2 else "b", home=0, rows=None,
                           batch=None, need=None, examples=1, tokens=3)

        def admit(self, req):
            return req.tenant == "a"

        def issue(self, req, t):
            return ReadyHandle(torch.tensor([t]))

        def compute(self, req, payload):
            return payload * 2

        def commit(self, req, out, t):
            self.served.append(int(out))
            return {}

    src = Src()
    summary = ServingEngine(src, prefetch=True).run(6)
    assert src.served == [2, 6, 10]
    assert summary["requests"] == 3 and summary["shed_per_tenant"] == {"b": 3}
    assert summary["tokens"] == 9
    src.obs = object()
    with pytest.raises(NotImplementedError, match="obs"):
        ServingEngine(src)
