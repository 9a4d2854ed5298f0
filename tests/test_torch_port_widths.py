"""The port at widths its CUDA kernels take zero-padded, against the JAX
package: head widths that are not a multiple of 8 (dk 10 and 20) and a
channel count that is not a multiple of 32 (C 20).  K1, K3 and K2's plain
versions against the Pallas kernels in interpret mode; the padding the
wrappers do on the card (``ops/pad_pack.py``: the jobs of
``rel_attention.head_jobs`` and ``wavenet_stack.channel_jobs``, run here by
the padding kernel's plain version) changes no result; the synthesis slice
and one train step at hidden 20 against JAX with converted weights and the
same noise.

Tolerances (float32): 1e-5 per kernel (the same arithmetic summed in
another order); 1e-6 between a padded and an unpadded plain run (zero
columns added to the same sums); on mu_p, logs_p and f0 1e-4, on the
waveform 1e-4 of its peak, on each metric of the train step 1e-4 relative
(the stated limits of ``test_torch_port_slice.py`` and
``test_torch_port_train.py``)."""

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visinger_tpu.ops.pallas.attention_kernel as ak
import visinger_tpu.ops.pallas.wavenet_kernel as wk
from visinger_tpu_torch.ops import pad_pack
from visinger_tpu_torch.ops import rel_attention as ra
from visinger_tpu_torch.ops import wavenet_stack as ws
from visinger_tpu_torch.training.train_state import create_train_state
from visinger_tpu_torch.training.train_step import make_train_step

import test_torch_port_cores  # noqa: F401  (shares the cores)
from test_torch_port_kernels import (LENGTHS, _attention_inputs,
                                     _pack_heads, _stack_inputs, max_err, t)
from test_torch_port_slice import (B, T, jax_decode, jax_inputs, jax_prior,
                                   make_slice_pair, port_inputs)
from test_torch_port_train import jax_draws, lockstep_pair

ATOL = 1e-5
PAD_ATOL = 1e-6
HIDDEN = 20          # dk 10 with 2 heads; K2 at C 20


@pytest.fixture
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ak.pl, "pallas_call", patched)
    monkeypatch.setattr(wk.pl, "pallas_call", patched)


def _unpack_heads(a, heads, dk):
    """[B, T, H*128] -> [B, T, H*dk]."""
    b, n, _ = a.shape
    return np.asarray(a).reshape(b, n, heads, ak.LANE)[..., :dk].reshape(
        b, n, heads * dk)


@pytest.mark.parametrize("dk", [10, 20])
def test_k1_plain_matches_pallas_at_off_grid_head_width(dk, interpret_mode):
    """K1's plain version against ``_attn_fwd_kernel`` at a head width the
    CUDA kernel takes padded (valid rows: the Pallas entry spreads a
    masked row over its 128 padded keys, test_torch_port_kernels.py)."""
    heads, window = 2, 4
    q, k, v, ek, ev, mask = _attention_inputs(c=heads * dk, heads=heads,
                                              window=window, seed=dk)
    scale = dk ** -0.5
    ref = ak.rel_attention(*(jnp.asarray(_pack_heads(a, heads))
                             for a in (q, k, v)),
                           jnp.asarray(ek), jnp.asarray(ev),
                           jnp.asarray(mask[..., 0]), window=window,
                           scale=scale)
    out = ra.rel_attention(t(q), t(k), t(v), t(ek), t(ev), t(mask),
                           window=window, scale=scale).numpy()
    valid = mask[..., 0] > 0
    assert max_err(out[valid], _unpack_heads(ref, heads, dk)[valid]) < ATOL


@pytest.mark.parametrize("dk", [10, 20])
def test_k3_plain_matches_pallas_at_off_grid_head_width(dk, interpret_mode):
    """K3's plain version against ``_attn_bwd_rule`` at a head width the
    CUDA kernel takes padded, g zero at masked rows."""
    heads, window = 2, 4
    q, k, v, ek, ev, mask = _attention_inputs(c=heads * dk, heads=heads,
                                              window=window, seed=dk + 1)
    scale = dk ** -0.5
    g = np.random.RandomState(dk).randn(*q.shape).astype(np.float32) * mask

    def f(qp, kp, vp, ek_, ev_):
        return ak.rel_attention(qp, kp, vp, ek_, ev_,
                                jnp.asarray(mask[..., 0]), window=window,
                                scale=scale)

    packed = [jnp.asarray(_pack_heads(a, heads)) for a in (q, k, v)]
    _, vjp = jax.vjp(f, *packed, jnp.asarray(ek), jnp.asarray(ev))
    ref = vjp(jnp.asarray(_pack_heads(g, heads)))
    got = ra.rel_attention_bwd_plain(
        t(q), t(k), t(v), t(ek), t(ev), torch.tensor(LENGTHS), t(g),
        window=window, scale=scale)
    for name, a, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert max_err(a, _unpack_heads(r, heads, dk)) < ATOL, name
    for name, a, r in zip(("d_emb_rel_k", "d_emb_rel_v"), got[3:], ref[3:]):
        assert max_err(a, np.asarray(r)[:2 * window + 1, :dk]) < ATOL, name


@pytest.mark.parametrize("with_g", [False, True])
def test_k2_plain_matches_pallas_at_c20(with_g, interpret_mode):
    x, w_in, b_in, w_rs, b_rs, g_bias, mask = _stack_inputs(c=HIDDEN, seed=3)
    if not with_g:
        g_bias = None
    ref = wk.wavenet_fused_forward(
        *(jnp.asarray(a) for a in (x, w_in, b_in, w_rs, b_rs)),
        g_bias=None if g_bias is None else jnp.asarray(g_bias),
        mask=jnp.asarray(mask), t_blk=16)
    out = ws.wavenet_stack(*(t(a) for a in (x, w_in, b_in, w_rs, b_rs)),
                           None if g_bias is None else t(g_bias), t(mask))
    assert max_err(out, ref) < ATOL


def test_pad_pack_plain_pads_each_group_and_cuts_back():
    """A job pads every group of every row to its width with zeros, adds
    zero rows, and the cut gives the input back."""
    x = torch.arange(1, 2 * 3 * 2 * 5 + 1, dtype=torch.float32).reshape(
        2, 3, 10)                                     # A=2, R=3, G=2, D=5
    dims = (3, 4, 2, 5, 8)
    out = pad_pack.pack_plain(x, dims, (2, 4, 16))
    grid = out.reshape(2, 4, 2, 8)
    assert torch.equal(grid[:, :3, :, :5], x.reshape(2, 3, 2, 5))
    assert float(grid[:, 3].abs().sum()) == 0.0
    assert float(grid[..., 5:].abs().sum()) == 0.0
    back = pad_pack.pack(
        [(out, dims, (2, 3, 10))], unpack=True)[0]     # CPU: the plain version
    assert torch.equal(back, x) and back.is_contiguous()
    assert pad_pack.padded(90, 8) == 96 and pad_pack.padded(96, 8) == 96
    assert pad_pack.padded(180, 32) == 192 and pad_pack.padded(1, 32) == 32


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c,heads", [(20, 2), (180, 2), (200, 4)])
def test_padded_heads_change_no_result(c, heads, dtype):
    """K1 and K3 run on heads zero-padded to a multiple of 8, as the
    wrappers launch them on the card, give the unpadded results: out, the
    row statistics (K3 reads them) and every gradient, with dropout, the
    scale staying the real dk^-0.5; the pad then the cut is the identity."""
    dk, window, n = c // heads, 4, 24
    rng = np.random.RandomState(c)
    q, k, v, g = (torch.from_numpy(rng.randn(2, n, c).astype(np.float32))
                  .to(dtype) for _ in range(4))
    ek, ev = (torch.from_numpy(rng.randn(2 * window + 1, dk).astype(
        np.float32)) for _ in range(2))
    lens = torch.tensor([n, 13], dtype=torch.int32)
    kw = dict(window=window, scale=dk ** -0.5,
              seed=torch.tensor([7], dtype=torch.int32), rate=0.1)
    padded = ra.pad_heads((q, k, v, ek, ev, g), heads, dk)
    dkp = pad_pack.padded(dk, 8)
    assert padded[0].shape == (2, n, heads * dkp) and padded[0].dtype == dtype
    assert padded[3].shape == (2 * window + 1, dkp)
    back = ra.pad_heads(padded, heads, dk, unpack=True)
    assert all(torch.equal(a, b) for a, b in zip(back, (q, k, v, ek, ev, g)))

    out, stats = ra.rel_attention_plain(q, k, v, ek, ev, lens, **kw,
                                        with_stats=True)
    out_p, stats_p = ra.rel_attention_plain(*padded[:5], lens, **kw,
                                            with_stats=True)
    got = ra.pad_heads((out_p,), heads, dk, unpack=True)[0]
    assert max_err(got.float(), out.float()) <= PAD_ATOL
    assert max_err(stats_p, stats) <= PAD_ATOL
    heads_p = out_p.float().reshape(2, n, heads, dkp)
    assert float(heads_p[..., dk:].abs().max()) == 0.0   # padded columns
    want = ra.rel_attention_bwd_plain(q, k, v, ek, ev, lens, g, **kw)
    grads = ra.pad_heads(ra.rel_attention_bwd_plain(
        *padded[:5], lens, padded[5], **kw), heads, dk, unpack=True)
    for name, a, r in zip(("dq", "dk", "dv", "dek", "dev"), grads, want):
        assert a.dtype == r.dtype and a.shape == r.shape, name
        assert max_err(a.float(), r.float()) <= PAD_ATOL, name


@pytest.mark.parametrize("c", [20, 180])
def test_padded_channels_change_no_result(c):
    """K2 run on channels zero-padded to a multiple of 32, each gate half
    and each res/skip half on its own, as the wrapper launches it on the
    card: the padded channels gate to exactly 0 and the cut skip sum is
    the unpadded one."""
    x, w_in, b_in, w_rs, b_rs, g_bias, mask = (
        t(a) for a in _stack_inputs(c=c, layers=3, seed=c))
    want = ws.wavenet_stack_plain(x, w_in, b_in, w_rs, b_rs, g_bias, mask)
    g_all = ws._bias(b_in, g_bias, x.shape[0]).contiguous()
    x_p, w_in_p, g_p, w_rs_p, b_rs_p = ws.pad_channels(x, w_in, g_all, w_rs,
                                                       b_rs)
    cp = pad_pack.padded(c, 32)
    assert w_in_p.shape == (3, 5, cp, 2 * cp) and g_p.shape[-1] == 2 * cp
    # each half padded on its own: the sigmoid half starts at column cp
    assert torch.equal(w_in_p[..., :c, cp:cp + c], w_in[..., c:])
    out = ws.wavenet_stack_plain(x_p, w_in_p, torch.zeros(3, 2 * cp), w_rs_p,
                                 b_rs_p, g_p, mask)
    assert float(out[..., c:].abs().max()) == 0.0
    assert max_err(ws.cut_channels(out.contiguous(), c), want) < ATOL


def test_infer_prior_and_decode_match_jax_at_hidden_20():
    """``infer_prior`` then ``decode_frames`` at hidden 20 (dk 10, K2 at
    C 20) against the JAX model, the same weights and prior noise."""
    apply, decode, params, port, raw = make_slice_pair(hidden_size=HIDDEN)
    ref = jax_prior(apply, params, jax_inputs(raw))
    eps = np.random.RandomState(21).randn(*ref["mu_p"].shape).astype(
        np.float32)
    assert eps.shape == (B, T, HIDDEN)
    with torch.no_grad():
        st = port.prior_stats(*port_inputs(raw))
        z_p, mask = port.infer_prior(*port_inputs(raw),
                                     eps=torch.from_numpy(eps))
        wav = port.decode_frames(z_p, mask, spk_id=port_inputs(raw)[-1])
    for key in ("mu_p", "logs_p", "f0_pred"):
        assert max_err(st[key], ref[key]) < 1e-4, key
    z_ref = (ref["mu_p"] + eps * np.exp(ref["logs_p"])) * mask.numpy()
    assert max_err(z_p, z_ref) < 1e-4
    wav_ref = jax_decode(decode, params, z_p.numpy(), raw["mel2ph"],
                         jnp.asarray(raw["spk_ids"]))
    peak = float(np.abs(wav_ref).max())
    assert peak > 1e-3
    assert max_err(wav, wav_ref) < 1e-4 * peak


def test_train_step_matches_jax_at_hidden_20():
    """One ``train_step`` at hidden 20 against the jitted JAX step from the
    same parameters, the JAX step's draws handed to the port: every metric
    within 1e-4 relative."""
    pair = lockstep_pair(hidden_size=HIDDEN)
    cfg, raw = pair["cfg"], pair["raw"]
    assert (cfg.hidden_size, pair["jcfg"].hidden_size) == (HIDDEN, HIDDEN)
    state = create_train_state(pair["model"], pair["disc"], seed=0)
    train_step = make_train_step(cfg, pair["model"], pair["disc"],
                                 device="cpu")
    ref_out, eps_q = jax_draws(pair, pair["jstate"])
    _, ref = pair["step_fn"](pair["jstate"], pair["jbatch"])
    _, got = train_step(state, raw, eps_q=eps_q,
                        ids_slice=ref_out["ids_slice"])
    assert set(got) == set(ref)
    for key in ref:
        r, g = float(ref[key]), float(got[key])
        assert np.isfinite(g), key
        assert abs(g - r) <= 1e-4 * abs(r) + 1e-7, (key, g, r)
