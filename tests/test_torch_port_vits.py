"""The port's VITS (``models/vits.py``, ``modules/sdp.py``, ``ops/mas.py``,
the "vits" kind of ``ops/stft.py``) against the benchmark's plain
reference (``benchmark/reference/vits.py``, ``sdp.py``, ``mas.py``) at
``tiny_vits`` size on seeded random weights, and the literal upstream MAS
loop against both vectorised forms bit for bit.  No JAX: the JAX package
has no VITS."""

import math
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import test_torch_port_cores  # noqa: F401  (shares the cores)
from visinger_tpu_torch import config as port_config
from visinger_tpu_torch.config import tiny_vits, vits_ljs
from visinger_tpu_torch.models import vits as pvits
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.modules import sdp as psdp
from visinger_tpu_torch.ops import mas as pmas
from visinger_tpu_torch.ops import stft as pstft
from visinger_tpu_torch.ops.mel_filters import mel_filterbank_slaney
from visinger_tpu_torch.training import losses as plosses
from visinger_tpu_torch.training.train_state import (create_train_state,
                                                     make_optimizers)
from visinger_tpu_torch.training.train_step import make_train_step

BENCH = Path(__file__).resolve().parents[1] / "benchmark"
if str(BENCH) not in sys.path:
    sys.path.insert(0, str(BENCH))

import correct  # noqa: E402
import weights  # noqa: E402
from reference import discriminator as rdisc  # noqa: E402
from reference import mas as rmas  # noqa: E402
from reference import sdp as rsdp  # noqa: E402
from reference import train as rtrain  # noqa: E402
from reference import vits as rvits  # noqa: E402

SEED = 1234
VOCAB = 20


def _tokens(lengths, n, gen):
    b = len(lengths)
    tok = torch.randint(0, VOCAB, (b, n), generator=gen)
    return tok * (torch.arange(n)[None] < torch.tensor(lengths)[:, None])


def _gen(seed=7):
    return torch.Generator().manual_seed(seed)


# --- the text encoder and the prior's statistics ---------------------------

@pytest.mark.parametrize("train", [False, True])
def test_text_encoder_and_prior_stats_match_the_reference(train):
    cfg = tiny_vits()
    port, ref = pvits.TextEncoder(VOCAB, cfg), rvits.TextEncoder(VOCAB, cfg)
    weights.fill(SEED, enc=port)
    weights.fill(SEED, enc=ref)
    port.train(train)
    ref.train(train)
    lengths = [9, 5, 7]
    tok = _tokens(lengths, 9, _gen())
    got = port(tok, torch.tensor(lengths), _gen(3) if train else None)
    want = ref(tok, torch.tensor(lengths), _gen(3) if train else None)
    mask = got[3]
    assert torch.equal(mask, want[3])
    for a, b in zip(got[:3], want[:3]):
        torch.testing.assert_close(a * mask, b * mask, rtol=1e-5, atol=1e-5)


# --- the stochastic duration predictor -------------------------------------

def _sdp_pair(cfg):
    port = psdp.StochasticDurationPredictor(
        cfg.hidden_size, cfg.sdp_filter_channels, cfg.sdp_kernel_size,
        cfg.sdp_p_dropout, cfg.sdp_n_flows, 0, cfg.sdp_num_bins,
        cfg.sdp_tail_bound)
    ref = rsdp.StochasticDurationPredictor(
        cfg.hidden_size, cfg.sdp_filter_channels, cfg.sdp_kernel_size,
        cfg.sdp_p_dropout, cfg.sdp_n_flows, cfg.sdp_num_bins,
        cfg.sdp_tail_bound)
    weights.fill(SEED, dp=port)
    weights.fill(SEED, dp=ref)
    return port, ref


def _sdp_inputs(scale=1.0):
    g = _gen(11)
    lengths = torch.tensor([6, 4, 5])
    mask = (torch.arange(6)[None] < lengths[:, None]).float()[:, None]
    x = torch.randn(3, 16, 6, generator=g)
    w = (torch.randint(1, 6, (3, 1, 6), generator=g).float() * mask)
    e_q = torch.randn(3, 2, 6, generator=g) * scale
    return x, mask, w, e_q


@pytest.mark.parametrize("train", [False, True])
def test_sdp_training_nll_and_gradients_match_the_reference(train):
    port, ref = _sdp_pair(tiny_vits())
    port.train(train)
    ref.train(train)
    x, mask, w, e_q = _sdp_inputs()
    got = port(x, mask, w, generator=_gen(5), e_q=e_q)
    want = ref(x, mask, w, generator=_gen(5), e_q=e_q)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
    gp = torch.autograd.grad(got.sum(), list(port.parameters()))
    gr = torch.autograd.grad(want.sum(), list(ref.parameters()))
    for (name, _), a, b in zip(port.named_parameters(), gp, gr):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-4, msg=name)


@pytest.mark.parametrize("scale", [1.0, 8.0])
def test_sdp_reverse_matches_the_reference(scale):
    port, ref = _sdp_pair(tiny_vits())
    port.eval()
    ref.eval()
    x, mask, _, e_q = _sdp_inputs(scale)
    got = port(x, mask, reverse=True, e_q=e_q)
    want = ref(x, mask, reverse=True, e_q=e_q)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("scale", [0.5, 3.0, 9.0])
def test_conv_flow_inverts_itself_inside_and_outside_the_tails(scale):
    torch.manual_seed(0)
    flow = psdp.ConvFlow(2, 16, 3, 3)
    weights.fill(SEED, f=flow)
    x = torch.randn(2, 2, 7, generator=_gen(2)) * scale
    mask = torch.ones(2, 1, 7)
    g = torch.randn(2, 16, 7, generator=_gen(4))
    y, logdet = flow(x, mask, g=g)
    back = flow(y, mask, g=g, reverse=True)
    torch.testing.assert_close(back, x, rtol=1e-4, atol=1e-4)
    # outside the tail bound the spline is the identity
    outside = x[:, 1:].abs() > 5.0
    assert torch.equal(y[:, 1:][outside], x[:, 1:][outside])
    assert torch.isfinite(logdet).all()


@pytest.mark.parametrize("inverse", [False, True])
def test_spline_matches_upstreams_masked_form(inverse):
    g = _gen(9)
    x = torch.randn(4, 1, 12, generator=g) * 4.0
    wu, hu = (torch.randn(4, 1, 12, 10, generator=g) for _ in range(2))
    du = torch.randn(4, 1, 12, 9, generator=g)
    got = psdp.rq_spline(x, wu, hu, du, inverse, 5.0)
    want = rsdp.unconstrained_rational_quadratic_spline(
        x, wu, hu, du.clone(), inverse=inverse, tail_bound=5.0)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)


# --- monotonic alignment search ---------------------------------------------

def _costs(kind, b=5, ty=23, tx=11, seed=3):
    rng = np.random.default_rng(seed)
    if kind == "random":
        v = rng.standard_normal((b, ty, tx)).astype(np.float32) * 50
    elif kind == "ties":
        v = rng.integers(-2, 3, (b, ty, tx)).astype(np.float32)
    else:                                              # t_x == t_y
        v = rng.standard_normal((b, ty, ty)).astype(np.float32)
        return v, np.full(b, ty), np.full(b, ty)
    t_x = rng.integers(2, tx + 1, b)
    t_y = np.maximum(rng.integers(2, ty + 1, b), t_x)
    t_x[0], t_y[0] = tx, ty                            # one item fills all
    return v, t_x, t_y


@pytest.mark.parametrize("kind", ["random", "ties", "square"])
def test_vectorised_mas_is_the_literal_loop_bit_for_bit(kind):
    cost, t_x, t_y = _costs(kind)
    value = cost.copy()
    pmas.dp_forward(value, t_x, t_y)
    path = pmas.dp_backtrack(value, t_x, t_y)
    for i in range(len(t_x)):
        loop_value = cost[i].copy()
        loop = rmas.path_each_loop(loop_value, int(t_y[i]), int(t_x[i]))
        ty_i, tx_i = int(t_y[i]), int(t_x[i])
        # the accumulated values, every cell of the item, the same bits
        assert np.array_equal(value[i, :ty_i, :tx_i].view(np.int32),
                              loop_value[:ty_i, :tx_i].view(np.int32))
        assert np.array_equal(path[i, :ty_i], rmas.tokens_of(loop))
        assert np.array_equal(rmas.path_each(cost[i], ty_i, tx_i), loop)
        # monotone, each token at least one frame, first and last tokens
        steps = np.diff(path[i, :ty_i])
        assert set(steps.tolist()) <= {0, 1}
        assert path[i, 0] == 0 and path[i, ty_i - 1] == tx_i - 1
    if kind == "square":
        assert np.array_equal(path, np.tile(np.arange(t_y[0]),
                                            (len(t_y), 1)))


@pytest.mark.parametrize("kind", ["random", "ties"])
def test_maximum_path_is_the_reference_maximum_path(kind):
    cost, t_x, t_y = _costs(kind, seed=8)
    got = pmas.maximum_path(torch.from_numpy(cost), t_x, t_y)
    mask = torch.from_numpy(
        (np.arange(cost.shape[1])[None, :, None] < t_y[:, None, None])
        & (np.arange(cost.shape[2])[None, None, :] < t_x[:, None, None])
    ).float()
    dense = rmas.maximum_path(torch.from_numpy(cost), mask)
    for i in range(len(t_x)):
        assert torch.equal(got[i, :t_y[i]], dense[i, :t_y[i]].argmax(-1))
    assert np.array_equal(cost, _costs(kind, seed=8)[0])   # left as it was


def test_neg_cent_matches_the_reference():
    g = _gen(21)
    z_p = torch.randn(3, 16, 13, generator=g)
    m_p = torch.randn(3, 16, 5, generator=g)
    logs_p = torch.randn(3, 16, 5, generator=g) * 0.3
    torch.testing.assert_close(pmas.neg_cent(z_p, m_p, logs_p),
                               rvits.neg_cent(z_p, m_p, logs_p),
                               rtol=1e-5, atol=1e-4)


# --- the spectrogram and the mel ---------------------------------------------

@pytest.mark.parametrize("which", ["tiny", "ljs_base"])
def test_vits_spectrogram_and_mel_match_the_reference(which):
    cfg = tiny_vits() if which == "tiny" else vits_ljs()
    params = pstft.STFTParams.from_config(cfg)
    ref = rvits.Spectrogram(cfg, "cpu")
    frames = 12
    wav = torch.randn(2, frames * cfg.hop_size, generator=_gen(1)) * 0.3
    spec = pstft.linear_spectrogram(wav, params)
    assert spec.shape == (2, frames, cfg.num_linear_bins)
    torch.testing.assert_close(spec, ref.spec(wav).transpose(1, 2),
                               rtol=1e-4, atol=1e-5)
    mel = pstft.log_mel_spectrogram(wav, params)
    torch.testing.assert_close(mel, ref.mel(wav).transpose(1, 2),
                               rtol=1e-4, atol=1e-4)
    ids = torch.tensor([3, 0])
    sl = pstft.log_mel_slices(wav, ids, 4, params)
    for i, s in enumerate(ids.tolist()):
        torch.testing.assert_close(sl[i], mel[i, s:s + 4])
    torch.testing.assert_close(
        torch.from_numpy(mel_filterbank_slaney(
            cfg.fft_size, cfg.fmin, cfg.fmax, cfg.num_mel_bins,
            cfg.sample_rate)).T,
        torch.from_numpy(rvits.librosa_mel(cfg.sample_rate, cfg.fft_size,
                                           cfg.num_mel_bins, cfg.fmin,
                                           cfg.fmax)), rtol=1e-6, atol=1e-9)


# --- one step of TrainStep against the reference step ------------------------

def _batch(cfg, seed=5):
    g = _gen(seed)
    lengths, frames = [9, 7, 5], [30, 26, 20]
    tok = _tokens(lengths, 9, g)
    wav = torch.zeros(3, 30 * cfg.hop_size)
    for i, f in enumerate(frames):
        wav[i, :f * cfg.hop_size] = 0.3 * torch.randn(f * cfg.hop_size,
                                                      generator=g)
    return {"text_tokens": tok, "text_lengths": torch.tensor(lengths),
            "wavs": wav, "mel_lengths": torch.tensor(frames)}


def _program(cfg):
    model, disc = build_models(cfg, VOCAB, device="cpu")
    weights.fill(SEED, model=model, disc=disc)
    state = create_train_state(model, disc, seed=77)
    return model, disc, state, make_train_step(cfg, model, disc, "cpu")


def _reference(cfg):
    model = rvits.VITS(cfg, VOCAB)
    disc = rdisc.MultiPeriodDiscriminator(
        tuple(cfg.disc_periods), cfg.disc_s_base, tuple(cfg.disc_p_channels),
        cfg.disc_pair_batch, cfg.use_spectral_norm)
    weights.fill(SEED, model=model, disc=disc)
    state = rtrain.ref_state(model, disc, 77)
    return model, disc, state, rvits.RefVITSStep(cfg, model, disc, "cpu")


@pytest.mark.parametrize("steps", [1, 2])
def test_a_train_step_matches_the_reference_step(steps):
    cfg = tiny_vits()
    batch = _batch(cfg)
    eps = torch.randn(3, 30, cfg.hidden_size, generator=_gen(8))
    ids = torch.tensor([10, 3, 0])
    model, disc, state, step = _program(cfg)
    rmodel, rdisc_, rstate, rstep = _reference(cfg)
    for _ in range(steps):
        state, got = step(state, batch, eps_q=eps, ids_slice=ids)
        want = rstep(rstate, batch, eps, ids)
    for k in ("total_g", "disc", "kl", "mel_l1", "dur", "adv", "fm",
              "gnorm_g"):
        torch.testing.assert_close(got[k], want[k], rtol=2e-5 * steps,
                                   atol=1e-5, msg=k)
    # Adam moves every element by about lr whatever its gradient's size, so
    # an element whose gradient is at round-off may step either way: after
    # the first step the gradients are held leaf by leaf, as the benchmark
    # holds them
    for side in ("g", "d"):
        mine = getattr(state, f"opt_state_{side}").mu
        theirs = getattr(rstate, f"opt_state_{side}").mu
        if steps == 1:
            for a, b in zip(mine, theirs):
                torch.testing.assert_close(a, b, rtol=1e-3, atol=5e-6)
        else:
            assert correct.worst_leaf_gap(correct.leaf_norms(mine),
                                          correct.leaf_norms(theirs)) < 1e-3
    for a, b in zip(model.parameters(), rmodel.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=2.5 * cfg.lr * steps)


def test_the_recipe_resolves_through_run_and_trains_a_step():
    """``--config vits_ljs`` through ``run``'s recipe lookup, cut to test
    size, builds a VITS and its discriminator and takes one step."""
    import dataclasses

    from visinger_tpu_torch import run

    cfg = run.load_config_arg("vits_ljs")
    assert cfg == vits_ljs() and port_config.RECIPES["vits_ljs"] is vits_ljs
    tiny = tiny_vits()
    cfg = cfg.replace(**{f.name: getattr(tiny, f.name)
                         for f in dataclasses.fields(tiny)
                         if getattr(tiny, f.name) != getattr(cfg, f.name)})
    model, disc = build_models(cfg, VOCAB, device="cpu")
    assert isinstance(model, pvits.VITS)
    assert {"text_encoder", "posterior_encoder", "flow", "decoder",
            "dp"} <= {n for n, _ in model.named_children()}
    state = create_train_state(model, disc, seed=3)
    state, metrics = make_train_step(cfg, model, disc, "cpu")(
        state, _batch(cfg))
    assert state.step == 1
    assert {"dur", "kl", "mel_l1", "adv", "fm"} <= set(metrics)
    assert all(bool(torch.isfinite(v)) for v in metrics.values())


def test_ljs_base_widths():
    cfg = vits_ljs()
    assert (cfg.hidden_size, cfg.ffn_filter_channels, cfg.ffn_kernel_size,
            cfg.num_heads, cfg.attn_window_size, cfg.enc_layers) == \
        (192, 768, 3, 2, 4, 6)
    assert (cfg.num_linear_bins, cfg.posterior_wn_layers,
            cfg.posterior_wn_kernel, cfg.flow_n_flows,
            cfg.flow_wn_layers) == (513, 16, 5, 4, 4)
    assert (cfg.upsample_rates, cfg.upsample_kernel_sizes,
            cfg.initial_upsample_channels) == ((8, 8, 2, 2), (16, 16, 4, 4),
                                               512)
    assert (cfg.sample_rate, cfg.hop_size, cfg.fft_size, cfg.num_mel_bins,
            cfg.segment_size * cfg.hop_size, cfg.max_sentences) == \
        (22050, 256, 1024, 80, 8192, 64)


# --- no clipping, no KL warm-up or floor ------------------------------------

def test_clip_grad_norm_zero_clips_nothing_and_reports_the_norm():
    opt_g, opt_d = make_optimizers(vits_ljs())
    assert opt_g.max_norm == opt_d.max_norm == math.inf
    assert opt_g.weight_decay == opt_d.weight_decay == 0.01
    params = [torch.randn(5, generator=_gen(1)), torch.randn(3, 2)]
    grads = [torch.randn(5) * 100, torch.randn(3, 2) * 100]
    from visinger_tpu_torch.training.train_state import init_adam

    got, want = [p.clone() for p in params], [p.clone() for p in params]
    norm = opt_g.update(got, grads, init_adam(got))
    assert float(norm) == pytest.approx(float(torch.sqrt(sum(
        (g ** 2).sum() for g in grads))), rel=1e-6)
    # by hand: Adam's first step with the gradient unscaled
    lr, eps, wd = opt_g.lr, opt_g.eps, opt_g.weight_decay
    for p, g in zip(want, grads):
        p -= lr * (g / (g.abs() + eps) + wd * p)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("start,floor,step,want", [
    (0, None, 0, -3.0), (0, None, 5, -3.0), (1, 0.0, 0, 0.0),
    (1, 0.0, 2, 0.0), (4, 0.0, 2, 0.0)])
def test_kl_schedule_without_warm_up_or_floor(start, floor, step, want):
    kl = torch.tensor(-3.0)
    assert float(plosses.kl_schedule(kl, step, floor, start, 1.0)) == want
