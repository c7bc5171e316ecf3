"""silu and tanh-gelu rounded as JAX rounds them
(``repro_torch.kernels.elementwise``, ``layers.silu_stepwise`` and
``layers.gelu_stepwise``) against ``jax.nn.silu`` and ``jax.nn.gelu``.

Tolerances.  bfloat16: bit for bit (the plain versions round every
operation to bf16, as XLA does).  float32: XLA's ``exp`` and ``tanh`` are
its own approximations and ATen's are others (their ``exp`` results
differ by an ulp in about 9% of entries), so silu is held within 4 float32
ulps (3 at most on these inputs) and gelu within 2e-6 absolute (1 +
tanh(z) cancels for z near -1; the one-rounding ``F.gelu`` parts from JAX
by 9.5e-7 as well).  Both packages: where JAX gives 0 and the port a
subnormal or a value below 128 times the least normal, XLA's CPU flushed a
subnormal on the way (silu(-88) is -88 times 1 / (1 + 1.7e38), a
subnormal: JAX gives -0, the port -5.3e-37).
Gradients (float32): silu within 1e-6 relative and absolute; gelu within
1e-5 absolute (XLA's tanh derivative; ``F.gelu``'s backward parts by
6.7e-6 as well).  Blocks at
bfloat16 (the reduced dense, MoE, MLA + MoE and encoder-decoder MLPs):
within a quarter of JAX's own bf16 distance from its float32 run
(``torch_lm_family.bf16_block_matches``); the reduced zamba2-2.7b's bf16
decode logits the same.  The kernels themselves run only on the card:
``tests/test_torch_elementwise.py`` (no JAX) holds them to these plain
versions bit for bit there.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_family as FAM
from repro.models import layers as JL
from repro.models import moe as JMOE
from repro.models import transformer as JT
from repro.models.model import build_model as jax_build
from repro_torch.kernels import elementwise as EW
from repro_torch.models import layers as TL
from repro_torch.models import moe as TMOE
from repro_torch.models import transformer as TT

SPECIALS = [0.0, -0.0, np.inf, -np.inf, np.nan, -90.0, 90.0, 1e-30, -1e-30,
            88.0, -88.0, 5e-39]
DTYPES = {"bf16": (jnp.bfloat16, torch.bfloat16),
          "f32": (jnp.float32, torch.float32)}
SILU_ULPS = 4
GELU_ATOL = 2e-6
TINY = float(np.finfo(np.float32).tiny)   # the least normal float32


def _inputs(seed=0, n=200_000, scale=3.0):
    x = np.random.default_rng(seed).normal(0, scale, n).astype(np.float32)
    x[:len(SPECIALS)] = SPECIALS
    return x


def _pair(x, name):
    """The same values in JAX and in the port at one dtype."""
    jdt, tdt = DTYPES[name]
    xj = jnp.asarray(x, jdt)
    return xj, torch.from_numpy(np.array(xj.astype(jnp.float32))).to(tdt)


def _same(got: torch.Tensor, want, ulps: int = 0, atol: float = 0.0):
    """Equal bits in bf16; within ``ulps`` float32 ulps or ``atol`` in
    float32; NaNs and infinities where JAX's, and JAX's flushed zeros
    where the port has a subnormal.  Returns the float32 ulps apart."""
    g = got.float().numpy()
    w = np.asarray(jnp.asarray(want).astype(jnp.float32))
    nan = np.isnan(w)
    assert np.array_equal(np.isnan(g), nan)
    flushed = (w == 0) & (np.abs(g) < 128 * TINY)
    keep = ~nan & ~flushed
    if got.dtype == torch.bfloat16:
        gb = got.view(torch.int16).numpy()
        wb = np.asarray(want).view(np.int16)
        assert np.array_equal(gb[keep], wb[keep])
        return 0
    fin = np.isfinite(w) & keep
    assert np.array_equal(g[~fin & keep], w[~fin & keep])
    d = np.abs(g[fin].view(np.int32).astype(np.int64)
               - w[fin].view(np.int32).astype(np.int64))
    close = (d <= ulps) | (np.abs(g[fin] - w[fin]) <= atol)
    assert close.all(), float(np.abs(g[fin] - w[fin])[~close].max())
    return int(d.max())


# ------------------------------------------------------- the plain versions
@pytest.mark.parametrize("name", list(DTYPES))
def test_silu_plain_version_matches_jax(name):
    xj, xt = _pair(_inputs(0), name)
    want = jax.jit(jax.nn.silu)(xj)
    worst = _same(EW.silu_stepwise_ref(xt), want, SILU_ULPS)
    assert worst <= 3
    _same(EW.silu_stepwise(xt), want, SILU_ULPS)
    _same(TL.silu_stepwise(xt), want, SILU_ULPS)
    _same(TL.silu_stepwise(xt.clone().requires_grad_()).detach(), want,
          SILU_ULPS)


@pytest.mark.parametrize("name", list(DTYPES))
def test_gelu_plain_version_matches_jax(name):
    xj, xt = _pair(_inputs(1), name)
    want = jax.jit(jax.nn.gelu)(xj)
    _same(EW.gelu_stepwise_ref(xt), want, atol=GELU_ATOL)
    _same(EW.gelu_stepwise(xt), want, atol=GELU_ATOL)
    _same(TL.gelu_stepwise(xt), want, atol=GELU_ATOL)
    # the one-rounding forms part from JAX's bf16 in many entries
    if name == "bf16":
        for once in (torch.nn.functional.gelu(xt, approximate="tanh"),
                     torch.nn.functional.silu(xt)):
            assert not torch.equal(once, EW.gelu_stepwise_ref(xt))


@pytest.mark.parametrize("name", list(DTYPES))
def test_gelu_constants_are_jax_constants(name):
    jdt, tdt = DTYPES[name]
    c0, c1 = EW.gelu_constants(tdt)
    assert c0 == float(np.sqrt(2 / np.pi).astype(jdt))
    assert c1 == float(jnp.asarray(0.044715, jdt))


@pytest.mark.parametrize("act", ["silu", "gelu"])
def test_backward_matches_jax_grad(act):
    """float32 gradients of sum(act(x) * w) against ``jax.grad``."""
    rng = np.random.default_rng(2)
    x = rng.normal(0, 3, 4096).astype(np.float32)
    x[:4] = [0.0, -90.0, 90.0, 30.0]
    w = rng.normal(0, 1, 4096).astype(np.float32)
    jf = {"silu": jax.nn.silu, "gelu": jax.nn.gelu}[act]
    tf = {"silu": TL.silu_stepwise, "gelu": TL.gelu_stepwise}[act]
    want = jax.grad(lambda a: jnp.sum(jf(a) * w))(jnp.asarray(x))
    xt = torch.from_numpy(x.copy()).requires_grad_()
    (tf(xt) * torch.from_numpy(w)).sum().backward()
    assert bool(torch.isfinite(xt.grad).all())
    tol = {"silu": dict(rtol=1e-6, atol=1e-6), "gelu": dict(rtol=0,
                                                          atol=1e-5)}[act]
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want), **tol)
    # bf16 input: the gradient comes back in bf16, from the float32 form
    xb = torch.from_numpy(x.copy()).bfloat16().requires_grad_()
    tf(xb).float().sum().backward()
    assert xb.grad.dtype == torch.bfloat16


def test_wrappers_check_dtype_and_count_no_cpu_launch():
    EW.reset_launch_counts()
    for fn in (EW.silu_stepwise, EW.gelu_stepwise):
        for dt in (torch.float16, torch.int32, torch.float64):
            with pytest.raises(ValueError, match="float32 or bfloat16"):
                fn(torch.zeros(4, dtype=dt))
        y = fn(torch.ones(3, 5).t())     # a strided view
        assert y.shape == (5, 3)
    assert EW.LAUNCHES == {"silu_stepwise": 0, "gelu_stepwise": 0}


def test_dense_layouts_are_launched_without_a_copy():
    """The wrapper hands the kernel any tensor whose elements fill one
    dense block (a transposed product's output, as Mamba2's decode makes)
    and copies only the others (``ops._dense``)."""
    from repro_torch.kernels.elementwise.ops import _dense

    a = torch.zeros(3, 8)
    for t, dense in ((a, True), (a.t(), True), (a[1:], True),
                     (a.view(2, 3, 4).permute(2, 0, 1), True),
                     (torch.zeros(1, 5, 1), True), (torch.zeros(0), True),
                     (a[:, :4], False), (a[:, ::2], False),
                     (torch.zeros(5, 1).expand(5, 3), False)):
        assert _dense(t) == dense, (t.shape, t.stride())


# ------------------------------------------------------------- bf16 blocks
def _x(shape, seed=5):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("arch,kind", [("qwen3-14b", "swiglu"),
                                       ("whisper-medium", "gelu")])
def test_bf16_mlp_block_rounds_as_jax(arch, kind):
    """The MLP block of the reduced dense (SwiGLU) and encoder-decoder
    (tanh-gelu, biases drawn away from 0) configs at bf16."""
    jcfg, _ = FAM.configs(arch)
    assert jcfg.mlp == kind
    p = jax.tree.map(np.asarray, JL.init_mlp(jax.random.PRNGKey(0), jcfg))
    rng = np.random.default_rng(3)
    for k in ("bi", "bd"):
        if k in p:
            p[k] = rng.normal(0, 0.3, p[k].shape).astype(np.float32)
    tp = {k: FAM.t(v) for k, v in p.items()}
    rows = FAM.bf16_block_matches(
        lambda q, x, dtype: JL.apply_mlp(q, x, kind, dtype),
        lambda q, x, dtype: TL.apply_mlp(q, x, kind, dtype),
        p, tp, _x((2, 16, jcfg.d_model)))
    assert len(rows) == 1


def _layer0(arch):
    jm, jp, tm, tp = FAM.make_pair(arch)
    return (jm.cfg, jax.tree.map(lambda a: a[0], jp["stack"]), tm.cfg,
            tp["stack"][0])


def test_bf16_moe_layer_rounds_as_jax():
    """``apply_moe`` of the reduced mixtral-8x22b at bf16."""
    jc, jl, tc, tl = _layer0("mixtral-8x22b")
    FAM.bf16_block_matches(
        lambda p, x, dtype: JMOE.apply_moe(p, x, jc, dtype=dtype),
        lambda p, x, dtype: TMOE.apply_moe(p, x, tc, dtype=dtype),
        jl["moe"], tl["moe"], _x((2, 16, jc.d_model)))


def test_bf16_mla_moe_layer_rounds_as_jax():
    """A whole layer of the reduced deepseek-v2-236b (MLA attention, then
    the MoE with its shared experts) at bf16."""
    jc, jl, tc, tl = _layer0("deepseek-v2-236b")
    B, L = 2, 16
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L))

    def jfn(p, x, dtype):
        c = dataclasses.replace(jc, dtype=jnp.dtype(dtype).name)
        return JT.apply_layer(p, x, c, jnp.asarray(pos))[0]

    def tfn(p, x, dtype):
        c = dataclasses.replace(tc, dtype=str(dtype).removeprefix("torch."))
        return TT.apply_layer(p, x, c, torch.from_numpy(pos.copy()))[0]

    FAM.bf16_block_matches(jfn, tfn, jl, tl, _x((B, L, jc.d_model)))


def test_zamba2_bf16_logits_within_a_quarter():
    """The reduced zamba2-2.7b at bf16, 8 decode steps from JAX's weights:
    the logits within a quarter of JAX's own bf16 distance from its
    float32 run (the shared attention layer's MLP rounded its silu once
    before, at 0.30 of it)."""
    arch, steps = "zamba2-2.7b", 8
    jm, jp, tm, tp = FAM.make_pair(arch, dtype="bfloat16")
    jm32 = jax_build(FAM.configs(arch)[0])
    toks = FAM.prompt(tm.cfg, 2, steps, 2)
    step, step32 = jax.jit(jm.decode_step), jax.jit(jm32.decode_step)
    jc, jc32, tc = (jm.init_cache(2, steps), jm32.init_cache(2, steps),
                    tm.init_cache(2, steps))
    got, want, ref = [], [], []
    for s in range(steps):
        tok, pos = toks[:, s:s + 1], jnp.asarray(s, jnp.int32)
        w, jc = step(jp, {"token": jnp.asarray(tok), "pos": pos, "cache": jc})
        r, jc32 = step32(jp, {"token": jnp.asarray(tok), "pos": pos,
                              "cache": jc32})
        g, tc = tm.decode_step(tp, {"token": FAM.t(tok), "pos": s,
                                    "cache": tc})
        got.append(g.float().numpy())
        want.append(np.asarray(w, np.float32))
        ref.append(np.asarray(r))
    err, own = FAM.bf16_close(np.stack(got), np.stack(want), np.stack(ref),
                              FAM.BF16_BLOCK_FRACTION, "logits")
    assert own > 1e-3
