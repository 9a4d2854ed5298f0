"""The port's two kernel functions (plain PyTorch versions) against the JAX
package: K1 relative attention and K2 WaveNet stack, each against the Pallas
kernel in interpret mode and against the XLA module path, with weights
carried across by ``params_from_jax``.

Tolerance 1e-5 max abs in float32: the same arithmetic summed in another
order (scores, softmax and short dot products of length <= 5*16)."""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visinger_tpu.ops.pallas.attention_kernel as ak
import visinger_tpu.ops.pallas.wavenet_kernel as wk
from visinger_tpu.modules.flow import ResidualCouplingBlock as JFlow
from visinger_tpu.modules.transformer import RelativeEncoder as JEncoder
from visinger_tpu.modules.transformer import \
    RelativeMultiHeadAttention as JAttention
from visinger_tpu.modules.wavenet import WaveNet as JWaveNet
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.modules.flow import ResidualCouplingBlock
from visinger_tpu_torch.modules.transformer import (RelativeEncoder,
                                                    RelativeMultiHeadAttention)
from visinger_tpu_torch.modules.wavenet import WaveNet
from visinger_tpu_torch.ops.rel_attention import (rel_attention,
                                                  rel_attention_plain)
from visinger_tpu_torch.ops.wavenet_stack import (wavenet_stack,
                                                  wavenet_stack_plain)

ATOL = 1e-5


@pytest.fixture(autouse=True)
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ak.pl, "pallas_call", patched)
    monkeypatch.setattr(wk.pl, "pallas_call", patched)


def load_port(module, jax_params, path="m"):
    """Convert one JAX module's params and load them (strict) into
    ``module``; ``path`` is the module's path in a full model tree."""
    tree = jax.tree.map(np.asarray, jax_params)
    for key in reversed(path.split(".")):
        tree = {key: tree}
    sd = params_from_jax(tree)
    module.load_state_dict({k[len(path) + 1:]: v for k, v in sd.items()},
                           strict=True)
    return module


def prefix_mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(
        np.float32)[..., None]                          # [B, T, 1]


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# --- K1 -------------------------------------------------------------------

T_ATT = 40  # not a multiple of 128: the Pallas entry pads to 128
LENGTHS = [T_ATT, T_ATT - 3, 1]  # full, ragged, all rows but one masked


def _attention_inputs(c=16, heads=2, window=4, seed=0):
    rng = np.random.RandomState(seed)
    b, dk = len(LENGTHS), c // heads
    q, k, v = (rng.randn(b, T_ATT, c).astype(np.float32) for _ in range(3))
    ek, ev = (rng.randn(2 * window + 1, dk).astype(np.float32) * 0.5
              for _ in range(2))
    return q, k, v, ek, ev, prefix_mask(LENGTHS, T_ATT)


def _pack_heads(a, heads):
    """[B, T, H*dk] -> [B, T, H*128], each head zero-padded to 128 lanes."""
    b, n, c = a.shape
    dk = c // heads
    out = np.zeros((b, n, heads, ak.LANE), np.float32)
    out[..., :dk] = a.reshape(b, n, heads, dk)
    return out.reshape(b, n, heads * ak.LANE)


def test_rel_attention_plain_matches_pallas_kernel():
    heads, window = 2, 4
    q, k, v, ek, ev, mask = _attention_inputs(heads=heads, window=window)
    dk = ek.shape[1]
    scale = dk ** -0.5
    ref = ak.rel_attention(*(jnp.asarray(_pack_heads(a, heads))
                             for a in (q, k, v)),
                           jnp.asarray(ek), jnp.asarray(ev),
                           jnp.asarray(mask[..., 0]), window=window,
                           scale=scale)
    ref = np.asarray(ref).reshape(len(LENGTHS), T_ATT, heads, ak.LANE)
    ref = ref[..., :dk].reshape(len(LENGTHS), T_ATT, heads * dk)
    out = rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(mask),
                        window=window, scale=scale).numpy()
    # Rows past the length are fully masked: the Pallas entry pads T to 128
    # keys and spreads them uniformly over the padded keys, the XLA path
    # (and the port) over the T real ones; downstream masks drop them.
    # They are held against the XLA path in the module test below.
    valid = prefix_mask(LENGTHS, T_ATT)[..., 0] > 0
    assert max_err(out[valid], ref[valid]) < ATOL


def test_rel_attention_entry_uses_plain_version_on_cpu():
    q, k, v, ek, ev, mask = _attention_inputs()
    lengths = torch.tensor(LENGTHS, dtype=torch.int32)
    a = rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(mask), window=4,
                      scale=0.3)
    b = rel_attention_plain(t(q), t(k), t(v), t(ek), t(ev), lengths,
                            window=4, scale=0.3)
    assert torch.equal(a, b)
    with pytest.raises(ValueError, match="seed"):
        rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(mask), window=4,
                      scale=0.3, dropout_rate=0.1)
    seed = torch.tensor([5], dtype=torch.int32)
    a = rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(mask), window=4,
                      scale=0.3, dropout_rate=0.1, seed=seed)
    b = rel_attention_plain(t(q), t(k), t(v), t(ek), t(ev), lengths,
                            window=4, scale=0.3, seed=seed, rate=0.1)
    assert torch.equal(a, b)


def test_attention_module_matches_legacy_xla_path():
    c, heads = 16, 2
    x, _, _, _, _, mask = _attention_inputs(c=c, heads=heads, seed=1)
    x = x * mask
    jmod = JAttention(c, heads, 4, attn_impl="legacy")
    params = jmod.init(jax.random.PRNGKey(0), jnp.asarray(x),
                       jnp.asarray(mask))["params"]
    ref = jmod.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask))
    port = load_port(RelativeMultiHeadAttention(c, heads, 4), params)
    out = port(t(x).transpose(1, 2), t(mask).transpose(1, 2))
    # every row, the fully masked ones included (uniform over T keys)
    assert max_err(out.transpose(1, 2).detach(), ref) < ATOL


@pytest.mark.parametrize("with_g", [False, True])
def test_relative_encoder_matches_jax(with_g):
    c, heads, layers, gin = 16, 2, 2, 8
    x, _, _, _, _, mask = _attention_inputs(c=c, heads=heads, seed=2)
    x = x * mask
    g = np.random.RandomState(3).randn(len(LENGTHS), 1, gin).astype(
        np.float32) if with_g else None
    jenc = JEncoder(c, 2 * c, heads, layers, kernel_size=3, attn_impl="legacy")
    jargs = (jnp.asarray(x), jnp.asarray(mask),
             None if g is None else jnp.asarray(g))
    params = jenc.init(jax.random.PRNGKey(0), *jargs)["params"]
    ref = jenc.apply({"params": params}, *jargs)
    port = load_port(RelativeEncoder(c, 2 * c, heads, layers, 3,
                                     gin_channels=gin if with_g else 0),
                     params)
    out = port(t(x).transpose(1, 2), t(mask).transpose(1, 2),
               None if g is None else t(g).transpose(1, 2))
    assert max_err(out.transpose(1, 2).detach(), ref) < ATOL


# --- K2 -------------------------------------------------------------------

def _stack_inputs(b=2, n=50, c=16, layers=3, k=5, seed=0):
    rng = np.random.RandomState(seed)
    mask = prefix_mask([n, n - 13], n)
    x = rng.randn(b, n, c).astype(np.float32) * mask
    w_in = rng.randn(layers, k, c, 2 * c).astype(np.float32) * 0.15
    b_in = rng.randn(layers, 2 * c).astype(np.float32) * 0.1
    w_rs = rng.randn(layers, c, 2 * c).astype(np.float32) * 0.2
    b_rs = rng.randn(layers, 2 * c).astype(np.float32) * 0.1
    g_bias = rng.randn(b, layers, 2 * c).astype(np.float32) * 0.3
    return x, w_in, b_in, w_rs, b_rs, g_bias, mask


@pytest.mark.parametrize("with_g", [False, True])
def test_wavenet_stack_plain_matches_pallas_kernel(with_g):
    x, w_in, b_in, w_rs, b_rs, g_bias, mask = _stack_inputs()
    if not with_g:
        g_bias = None
    ref = wk.wavenet_fused_forward(
        *(jnp.asarray(a) for a in (x, w_in, b_in, w_rs, b_rs)),
        g_bias=None if g_bias is None else jnp.asarray(g_bias),
        mask=jnp.asarray(mask), t_blk=16)
    args = [t(a) for a in (x, w_in, b_in, w_rs, b_rs)]
    out = wavenet_stack(*args, None if g_bias is None else t(g_bias), t(mask))
    assert max_err(out, ref) < ATOL
    plain = wavenet_stack_plain(*args, None if g_bias is None else t(g_bias),
                                t(mask))
    assert torch.equal(out, plain)


@pytest.mark.parametrize("with_g", [False, True])
def test_wavenet_module_matches_jax(with_g):
    b, n, c, layers, gin = 2, 50, 16, 3, 8
    rng = np.random.RandomState(4)
    mask = prefix_mask([n, 31], n)
    x = rng.randn(b, n, c).astype(np.float32) * mask
    g = rng.randn(b, 1, gin).astype(np.float32) if with_g else None
    jwn = JWaveNet(c, 5, 1, layers, gin if with_g else 0)
    jargs = (jnp.asarray(x), jnp.asarray(mask),
             None if g is None else jnp.asarray(g))
    params = jwn.init(jax.random.PRNGKey(0), *jargs)["params"]
    ref = jwn.apply({"params": params}, *jargs)
    port = load_port(WaveNet(c, 5, layers, gin if with_g else 0), params)
    out = port(t(x).transpose(1, 2), t(mask).transpose(1, 2),
               None if g is None else t(g).transpose(1, 2))
    assert max_err(out.transpose(1, 2).detach(), ref) < ATOL


@pytest.mark.parametrize("reverse", [False, True])
def test_coupling_block_matches_jax_both_directions(reverse):
    b, n, c, gin = 2, 40, 16, 8
    rng = np.random.RandomState(5)
    mask = prefix_mask([n, 27], n)
    x = rng.randn(b, n, c).astype(np.float32) * mask
    g = rng.randn(b, 1, gin).astype(np.float32)
    jflow = JFlow(c, c, 5, 1, n_layers=2, n_flows=2, gin_channels=gin)
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    params = jax.tree.map(np.asarray,
                          jflow.init(jax.random.PRNGKey(0), *jargs)["params"])
    # post is zero-initialised, which would make each coupling the identity
    for i in range(2):
        post = params[f"coupling_{i}"]["post"]
        post["kernel"] = rng.randn(*post["kernel"].shape).astype(
            np.float32) * 0.3
    ref = jflow.apply({"params": params}, *jargs, reverse=reverse)
    assert max_err(ref, x) > 0.1  # the flow is not the identity
    port = load_port(ResidualCouplingBlock(c, c, 5, 2, 2, gin), params)
    out = port(t(x).transpose(1, 2), t(mask).transpose(1, 2),
               t(g).transpose(1, 2), reverse=reverse)
    assert max_err(out.transpose(1, 2).detach(), ref) < ATOL
