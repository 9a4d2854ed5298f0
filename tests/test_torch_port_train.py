"""The training slice of the port against the JAX package: K3's plain
version (attention backward) against the Pallas backward in interpret mode,
the attention-dropout hash, the STFT and the losses, the discriminators,
the posterior and phoneme heads, the training branch of ``VISinger``, the
optimizer chain, and a 2-step lockstep of ``train_step`` against the jitted
JAX ``make_train_step`` — weights carried across by ``params_from_jax``,
inputs from numpy seeds, the JAX step's random draws handed to the port.

Tolerances (float32), each the same arithmetic summed in another order:
1e-5 for kernels, modules and losses (relative to the peak where stated);
1e-6 on parameters after the optimizer chain; 1e-4 relative per metric in
the lockstep (two steps of the whole model, the second from parameters that
went through Adam's normalised first step)."""

import inspect

import jax
import jax.experimental.pallas as pl
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import visinger_tpu.ops.pallas.attention_kernel as ak
from visinger_tpu.models.factory import build_models as j_build_models
from visinger_tpu.models.factory import init_params
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.modules.discriminator import \
    MultiPeriodDiscriminator as JMPD
from visinger_tpu.modules.encoders import PhonemePredictor as JPhoneme
from visinger_tpu.modules.encoders import PosteriorEncoder as JPosterior
from visinger_tpu.modules.flow import ResidualCouplingLayer as JCoupling
from visinger_tpu.modules.transformer import RelativeEncoder as JEncoder
from visinger_tpu.modules.wavenet import WaveNet as JWaveNet
from visinger_tpu.ops import stft as jstft
from visinger_tpu.training import losses as JL
from visinger_tpu.training.train_state import \
    create_train_state as j_create_train_state
from visinger_tpu.training.train_state import \
    make_optimizers as j_make_optimizers
from visinger_tpu.training.train_step import \
    make_train_step as j_make_train_step
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.modules.discriminator import MultiPeriodDiscriminator
from visinger_tpu_torch.modules.encoders import (PhonemePredictor,
                                                 PosteriorEncoder)
from visinger_tpu_torch.modules.transformer import RelativeEncoder
from visinger_tpu_torch.ops import stft as pstft
from visinger_tpu_torch.ops.rel_attention import (dropout_bits, dropout_keep,
                                                  rel_attention_bwd_plain,
                                                  rel_attention_plain)
from visinger_tpu_torch.training import losses as PL
from visinger_tpu_torch.training.train_state import (create_train_state,
                                                     init_adam,
                                                     make_optimizers)
from visinger_tpu_torch.training.train_step import TrainStep, make_train_step

from test_torch_port_kernels import (LENGTHS, T_ATT, _attention_inputs,
                                     _pack_heads, load_port, max_err, t)
from test_torch_port_modules import fill_params

ATOL = 1e-5
VOCABS = (40, 96, 64)    # the JAX tiny_batch's vocabularies


def bct(a):
    """numpy [B, T, C] -> torch [B, C, T]."""
    return torch.from_numpy(np.asarray(a, np.float32)).transpose(1, 2)


# --- K3 and dropout ----------------------------------------------------------

def test_rel_attention_bwd_plain_matches_pallas_bwd(monkeypatch):
    """K3's plain version against ``_attn_bwd_rule`` (interpret mode),
    dropout off, T=40 (the Pallas entry pads to 128), g zero at masked rows
    as the model's masks make it."""
    orig = pl.pallas_call
    monkeypatch.setattr(ak.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    heads, window = 2, 4
    q, k, v, ek, ev, mask = _attention_inputs(heads=heads, window=window)
    dk = ek.shape[1]
    scale = dk ** -0.5
    g = np.random.RandomState(7).randn(*q.shape).astype(np.float32) * mask
    b = len(LENGTHS)

    def f(qp, kp, vp, ek_, ev_):
        return ak.rel_attention(qp, kp, vp, ek_, ev_, jnp.asarray(mask[..., 0]),
                                window=window, scale=scale)

    packed = [jnp.asarray(_pack_heads(a, heads)) for a in (q, k, v)]
    _, vjp = jax.vjp(f, *packed, jnp.asarray(ek), jnp.asarray(ev))
    ref = vjp(jnp.asarray(_pack_heads(g, heads)))

    def unpack(a):
        a = np.asarray(a).reshape(b, T_ATT, heads, ak.LANE)[..., :dk]
        return a.reshape(b, T_ATT, heads * dk)

    got = rel_attention_bwd_plain(
        t(q), t(k), t(v), t(ek), t(ev), torch.tensor(LENGTHS), t(g),
        window=window, scale=scale)
    for name, a, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert max_err(a, unpack(r)) < ATOL, name
    for name, a, r in zip(("d_emb_rel_k", "d_emb_rel_v"), got[3:], ref[3:]):
        assert max_err(a, np.asarray(r)[:2 * window + 1, :dk]) < ATOL, name


def test_relative_encoder_param_grads_match_jax():
    """Every parameter gradient of the port's encoder (K1/K3's plain
    versions under autograd) against ``jax.grad`` of the legacy path,
    within 1e-5 of the gradient's peak where that exceeds 1."""
    c, heads, layers, gin = 16, 2, 2, 8
    x, _, _, _, _, mask = _attention_inputs(c=c, heads=heads, seed=2)
    x = x * mask
    rng = np.random.RandomState(8)
    g = rng.randn(len(LENGTHS), 1, gin).astype(np.float32)
    w = rng.randn(*x.shape).astype(np.float32)
    jenc = JEncoder(c, 2 * c, heads, layers, kernel_size=3, attn_impl="legacy")
    jargs = (jnp.asarray(x), jnp.asarray(mask), jnp.asarray(g))
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), *jargs)
    params = fill_params(shapes["params"], 8)

    def loss(p):
        return jnp.sum(jenc.apply({"params": p}, *jargs) * w)

    ref = params_from_jax({"m": jax.tree.map(np.asarray,
                                             jax.jit(jax.grad(loss))(params))})
    port = load_port(RelativeEncoder(c, 2 * c, heads, layers, 3,
                                     gin_channels=gin), params)
    out = port(t(x).transpose(1, 2), t(mask).transpose(1, 2),
               t(g).transpose(1, 2))
    (out.transpose(1, 2) * t(w)).sum().backward()
    for name, p in port.named_parameters():
        r = ref[f"m.{name}"]
        assert max_err(p.grad, r) < ATOL * max(1.0, float(r.abs().max())), \
            name


def test_dropout_hash_pins_known_values_and_keep_rate():
    """The plain hash is the one in ``csrc/rel_attention.cu``: values pinned
    from a pure-Python uint32 evaluation of the same formula."""
    def bits(seed, b, h, t_, idx):
        out = dropout_bits(torch.tensor([seed], dtype=torch.int32), b, h, t_)
        return int(out[idx])

    assert bits(0, 1, 1, 1, (0, 0, 0, 0)) == 1680814304
    assert bits(1, 1, 1, 2, (0, 0, 0, 1)) == 3640910242
    assert bits(12345, 2, 2, 8, (1, 1, 7, 2)) == 3898786785
    assert bits(2 ** 31 - 2, 1, 2, 640, (0, 1, 639, 638)) == 2376242418
    keep = dropout_keep(torch.tensor([99], dtype=torch.int32), 2, 2, 64, 0.1)
    assert abs(float(keep.float().mean()) - 0.9) < 0.01


def test_dropout_backward_uses_the_forward_mask():
    """Autograd of the plain forward with a seed equals
    ``rel_attention_bwd_plain`` with that seed, and differs from another
    seed's and from no dropout."""
    q, k, v, ek, ev, mask = _attention_inputs()
    lengths = torch.tensor(LENGTHS)
    g = t(np.random.RandomState(9).randn(*q.shape))
    seed = torch.tensor([321], dtype=torch.int32)
    kw = dict(window=4, scale=0.35, rate=0.1)
    ins = [t(a).requires_grad_(True) for a in (q, k, v, ek, ev)]
    out = rel_attention_plain(*ins, lengths, seed=seed, **kw)
    auto = torch.autograd.grad(out, ins, g)
    got = rel_attention_bwd_plain(*ins, lengths, g, seed=seed, **kw)
    for a, b in zip(auto, got):
        assert torch.equal(a, b)
    other = rel_attention_bwd_plain(*ins, lengths, g, seed=seed + 1, **kw)
    off = rel_attention_bwd_plain(*ins, lengths, g, window=4, scale=0.35)
    assert max_err(other[2], got[2]) > 1e-3
    assert max_err(off[2], got[2]) > 1e-3


# --- STFT, losses --------------------------------------------------------------

def test_stft_functions_match_jax():
    rng = np.random.RandomState(10)
    wav = (rng.randn(2, 24 * 300) * 0.1).astype(np.float32)
    args = (2048, 1200, 300, 24000, 20.0, 12000.0, 128)
    jp, pp = jstft.STFTParams(*args), pstft.STFTParams(*args)
    ids = np.array([3, 11])
    ref_pow = np.asarray(jstft.power_spectrogram(jnp.asarray(wav), jp))
    got_pow = pstft.power_spectrogram(t(wav), pp)
    assert got_pow.shape == ref_pow.shape == (2, 24, 1025)
    assert max_err(got_pow, ref_pow) < ATOL * np.abs(ref_pow).max()
    ref_mel = np.asarray(jstft.log_mel_spectrogram(jnp.asarray(wav), jp))
    assert max_err(pstft.log_mel_spectrogram(t(wav), pp), ref_mel) < ATOL
    ref_sl = np.asarray(jstft.log_mel_slices(jnp.asarray(wav),
                                             jnp.asarray(ids), 8, jp))
    got_sl = pstft.log_mel_slices(t(wav), torch.from_numpy(ids), 8, pp)
    assert max_err(got_sl, ref_sl) < ATOL
    # the slices are the full spectrogram's frames
    assert max_err(got_sl[1], ref_mel[1, 11:19]) < ATOL


def test_losses_match_jax():
    rng = np.random.RandomState(11)
    w = np.array([1.0, 0.0, 1.0], np.float32)
    mel_out = rng.randn(3, 8, 12).astype(np.float32)
    mel_tgt = rng.randn(3, 8, 12).astype(np.float32)
    mel_tgt[0, 5:] = 0.0                        # silent frames carry no loss
    for ww in (None, w):
        jw = None if ww is None else jnp.asarray(ww)
        pw = None if ww is None else t(ww)
        for spec in ("l1:45.0", "l1:45.0|mse:2.0"):
            ref = JL.mel_losses_total(spec, jnp.asarray(mel_out),
                                      jnp.asarray(mel_tgt), jw)
            got = PL.mel_losses_total(spec, t(mel_out), t(mel_tgt), pw)
            assert abs(float(got) - float(ref)) < ATOL * abs(float(ref))
    for step in (0, 2, 5):
        ref = JL.kl_schedule(jnp.float32(3.0), jnp.int32(step), 0.5, 4, 2.0)
        assert float(PL.kl_schedule(torch.tensor(3.0), step, 0.5, 4, 2.0)) \
            == pytest.approx(float(ref), rel=1e-7)

    f0_pred = rng.randn(3, 10, 2).astype(np.float32)
    f0 = rng.uniform(7, 9, (3, 10)).astype(np.float32)
    uv = (rng.uniform(size=(3, 10)) < 0.3).astype(np.float32)
    mel2ph = np.repeat(np.arange(1, 6), 2)[None].repeat(3, 0)
    mel2ph[2, 7:] = 0
    ref = JL.pitch_losses(*(jnp.asarray(a) for a in (f0_pred, f0, uv, mel2ph)),
                          1.0, 10.0, jnp.asarray(w))
    got = PL.pitch_losses(t(f0_pred), t(f0), t(uv), torch.from_numpy(mel2ph),
                          1.0, 10.0, t(w))
    for a, r in zip(got, ref):
        assert abs(float(a) - float(r)) < ATOL * abs(float(r))

    # CTC: the second item has fewer valid frames (6) than labels (9), so it
    # is infeasible and counts 0
    vocab, n_frames = 7, 12
    logp = np.asarray(jax.nn.log_softmax(
        rng.randn(3, n_frames, vocab).astype(np.float32), axis=-1))
    mel_len = np.array([12, 6, 10], np.int32)
    txt_len = np.array([4, 9, 3], np.int32)
    tokens = np.zeros((3, 9), np.int32)
    for i, n in enumerate(txt_len):
        tokens[i, :n] = rng.randint(1, vocab, n)
    # jitted once (eager, the JAX CTC's unrolled scan dispatches op by op);
    # JAX's None weights are all ones
    j_ctc = jax.jit(JL.ctc_loss, static_argnums=4)
    for ww in (None, w):
        ref = j_ctc(*(jnp.asarray(a) for a in (logp, mel_len, tokens,
                                               txt_len)), 45.0,
                    jnp.ones(3) if ww is None else jnp.asarray(ww))
        got = PL.ctc_loss(t(logp), torch.from_numpy(mel_len),
                          torch.from_numpy(tokens), torch.from_numpy(txt_len),
                          45.0, None if ww is None else t(ww))
        assert abs(float(got) - float(ref)) < ATOL * abs(float(ref))

    scores_r = [rng.randn(3, n).astype(np.float32) for n in (5, 9)]
    scores_g = [rng.randn(3, n).astype(np.float32) for n in (5, 9)]
    fm_r = [[rng.randn(3, 4, 6).astype(np.float32) for _ in range(2)]] * 2
    fm_g = [[rng.randn(3, 4, 6).astype(np.float32) for _ in range(2)]] * 2
    J, P = (lambda a: [jnp.asarray(x) for x in a]), (lambda a: [t(x) for x in a])
    for ww in (None, w):
        jw = None if ww is None else jnp.asarray(ww)
        pw = None if ww is None else t(ww)
        pairs = [
            (JL.discriminator_loss(J(scores_r), J(scores_g), jw),
             PL.discriminator_loss(P(scores_r), P(scores_g), pw)),
            (JL.generator_adv_loss(J(scores_g), jw),
             PL.generator_adv_loss(P(scores_g), pw)),
            (JL.feature_matching_loss([J(f) for f in fm_r],
                                      [J(f) for f in fm_g], jw),
             PL.feature_matching_loss([P(f) for f in fm_r],
                                      [P(f) for f in fm_g], pw)),
        ]
        for ref, got in pairs:
            assert abs(float(got) - float(ref)) < ATOL * abs(float(ref))


# --- modules ---------------------------------------------------------------------

@pytest.mark.parametrize("pair_batch", [True, False])
def test_discriminator_scores_and_fmaps_match_jax(pair_batch):
    """MPD + MSD, with and without ``pair_batch``: scores and every feature
    map (the JAX maps are channels-last)."""
    rng = np.random.RandomState(12)
    y, y_hat = (rng.randn(2, 2400).astype(np.float32) * 0.3
                for _ in range(2))
    jd = JMPD(periods=(2, 3), s_base=4, p_channels=(8, 16, 32, 32),
              pair_batch=pair_batch)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(y),
                            jnp.asarray(y_hat))
    params = fill_params(shapes["params"], 12)
    ref = jax.jit(jd.apply)({"params": params}, jnp.asarray(y),
                            jnp.asarray(y_hat))
    port = MultiPeriodDiscriminator((2, 3), 4, (8, 16, 32, 32), pair_batch)
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(t(y), t(y_hat))
    for r_list, g_list in zip(ref[:2], got[:2]):
        for r, g in zip(r_list, g_list):
            assert g.shape == r.shape
            assert max_err(g, r) < ATOL
    for r_maps, g_maps in zip(ref[2] + ref[3], got[2] + got[3]):
        for r, g in zip(r_maps, g_maps):
            g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g.transpose(1, 2)
            assert g.shape == r.shape
            assert max_err(g, r) < ATOL * max(1.0, float(np.abs(r).max()))


def test_posterior_and_phoneme_predictor_match_jax():
    """The posterior with a given eps and the CTC head.  The posterior's
    and the flow's WaveNets have no dropout in the JAX package (the default
    rate 0, never overridden), so the port adds none."""
    for mod in (JPosterior, JCoupling):
        assert "p_dropout" not in inspect.getsource(mod)
    assert JWaveNet.p_dropout == 0.0
    rng = np.random.RandomState(13)
    b, n, bins, h, gin = 2, 24, 33, 16, 8
    mask = (np.arange(n)[None] < np.array([n, 17])[:, None]).astype(
        np.float32)[..., None]
    spec = np.abs(rng.randn(b, n, bins)).astype(np.float32) * mask
    g = rng.randn(b, 1, gin).astype(np.float32)
    key = jax.random.PRNGKey(3)
    jpost = JPosterior(h, h, 5, 1, 2, gin_channels=gin)
    jargs = (jnp.asarray(spec), jnp.asarray(mask), key, jnp.asarray(g))
    shapes = jax.eval_shape(jpost.init, jax.random.PRNGKey(0), *jargs)
    params = fill_params(shapes["params"], 13)
    ref = jax.jit(jpost.apply)({"params": params}, *jargs)
    eps = np.asarray(jax.random.normal(key, (b, n, h), jnp.float32))
    port = load_port(PosteriorEncoder(bins, h, h, 5, 2, gin), params)
    with torch.no_grad():
        got = port(bct(spec), bct(mask), bct(g), eps=bct(eps))
    for a, r in zip(got, ref):
        assert max_err(a.transpose(1, 2), r) < ATOL

    z = np.asarray(ref[0])
    jph = JPhoneme(20, h, 32, 2, 1, 3, 0.0, attn_impl="legacy")
    shapes = jax.eval_shape(jph.init, jax.random.PRNGKey(0), jnp.asarray(z),
                            jnp.asarray(mask))
    params = fill_params(shapes["params"], 14)
    ref = jax.jit(jph.apply)({"params": params}, jnp.asarray(z),
                             jnp.asarray(mask))
    port = load_port(PhonemePredictor(20, h, 32, 2, 1, 3), params)
    with torch.no_grad():
        got = port(bct(z), bct(mask))
    assert max_err(got.transpose(1, 2), ref) < ATOL


# --- optimizer -----------------------------------------------------------------

def test_optimizer_chain_matches_optax():
    """Clipped AdamW with the staircase decay, 5 steps across two decay
    boundaries (2 steps per epoch), gradients above and below the clip."""
    jcfg = jax_tiny_config(steps_per_epoch=2, scheduler_gamma=0.5)
    cfg = tiny_config().replace(steps_per_epoch=2, scheduler_gamma=0.5)
    rng = np.random.RandomState(15)
    shapes = [(3, 4), (5,), (2, 2, 2)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    for j_opt, p_opt in zip(j_make_optimizers(jcfg), make_optimizers(cfg)):
        jparams = {str(i): jnp.asarray(a) for i, a in enumerate(init)}
        jstate = j_opt.init(jparams)
        params = [torch.tensor(a) for a in init]
        state = init_adam(params)
        for step in range(5):
            scale = 3.0 if step % 2 else 0.05      # above and below the clip
            grads = [rng.randn(*s).astype(np.float32) * scale for s in shapes]
            upd, jstate = j_opt.update(
                {str(i): jnp.asarray(a) for i, a in enumerate(grads)},
                jstate, jparams)
            jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
            p_opt.update(params, [torch.tensor(a) for a in grads], state)
            for i, p in enumerate(params):
                assert max_err(p, jparams[str(i)]) < 1e-6, (step, i)


# --- the batch ------------------------------------------------------------------

def test_batch_dequantizes_int16_wavs_as_the_jax_step():
    """int16 ``wavs`` (PCM) become float32 / 32767, as the JAX step's
    ``astype(float32) / 32767.0``; float wavs pass unchanged; the integer
    token arrays become int64."""
    step = TrainStep.__new__(TrainStep)    # _batch needs only the device
    step.device = torch.device("cpu")
    rng = np.random.RandomState(16)
    pcm = rng.randint(-32768, 32768, size=(2, 300)).astype(np.int16)
    tokens = rng.randint(0, 40, size=(2, 7)).astype(np.int32)
    got = step._batch({"wavs": pcm, "text_tokens": tokens,
                       "mel_lengths": np.array([5, 3], np.int64)})
    want = np.asarray(jnp.asarray(pcm).astype(jnp.float32) / 32767.0)
    assert got["wavs"].dtype == torch.float32
    assert np.array_equal(got["wavs"].numpy(), want)
    assert got["text_tokens"].dtype == torch.int64
    assert np.array_equal(got["text_tokens"].numpy(), tokens)
    assert got["mel_lengths"].dtype == torch.int64
    wav = rng.uniform(-1, 1, size=(2, 300)).astype(np.float32)
    assert np.array_equal(step._batch({"wavs": wav})["wavs"].numpy(), wav)
    assert torch.equal(step._batch({"wavs": torch.from_numpy(pcm)})["wavs"],
                       got["wavs"])


# --- the training branch and the train step ------------------------------------

@pytest.fixture(scope="module")
def lockstep():
    """One JAX/port pair for the training slice: the tiny recipe without
    dropout (so the JAX step's only draws are the posterior noise and the
    slice starts), with ``disc_start_steps=1`` (step 0 gates the
    discriminator off, step 1 trains it) and one decoder resblock per
    stage; params filled from a seed; the JAX step and training apply
    jitted once."""
    # one resblock per upsampling stage: the decoder is the bulk of the JAX
    # step's compile time, and its parity is held in test_torch_port_slice
    small = dict(p_dropout=0.0, disc_start_steps=1, dec_kernel_size=(3,),
                 dec_dilation_sizes=((1, 3),))
    jcfg = jax_tiny_config(**small)
    cfg = tiny_config().replace(**small)
    raw = synthetic_batch(2, 12, 64, *VOCABS, cfg.num_linear_bins,
                          cfg.hop_size, seed=0)
    raw.pop("spec")
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel, jdisc = j_build_models(jcfg, *VOCABS)
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, jdisc, raw))
    params_g = fill_params(shapes[0], 20)
    params_d = fill_params(shapes[1], 21)
    jstate = j_create_train_state(jcfg, params_g, params_d,
                                  jax.random.PRNGKey(1))
    stft = jstft.STFTParams(jcfg.fft_size, jcfg.win_size, jcfg.hop_size,
                            jcfg.sample_rate, float(jcfg.fmin),
                            float(jcfg.fmax), jcfg.num_mel_bins)
    spec = jstft.power_spectrogram(jbatch["wavs"], stft)

    @jax.jit
    def apply_train(params, rngs):
        return jmodel.apply(
            {"params": params}, text_tokens=jbatch["text_tokens"],
            pitch_tokens=jbatch["note_pitch"], dur_tokens=jbatch["note_dur"],
            mel2ph=jbatch["mel2ph"], spk_id=jbatch["spk_ids"],
            f0=jbatch["f0"], uv=jbatch["uv"], spec=spec,
            lengths=jbatch["mel_lengths"], infer=False, deterministic=False,
            rngs=rngs)

    step_fn = jax.jit(j_make_train_step(jcfg, jmodel, jdisc))
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    model.load_state_dict(params_from_jax(params_g), strict=True)
    disc.load_state_dict(params_from_jax(params_d), strict=True)
    return dict(cfg=cfg, raw=raw, jbatch=jbatch, jstate=jstate,
                apply_train=apply_train, step_fn=step_fn, model=model,
                disc=disc)


def jax_draws(pair, jstate):
    """The JAX step's posterior noise and slice starts for ``jstate``:
    the train step's key split, one training apply with those keys, and
    eps_q recovered from z_q = (mu_q + eps_q exp(logs_q)) * mask."""
    _, k_sample, k_drop = jax.random.split(jstate.rng, 3)
    out = pair["apply_train"](jstate.params_g,
                              {"sample": k_sample, "dropout": k_drop})
    out = {k: np.asarray(v) for k, v in out.items()}
    mask = (pair["raw"]["mel2ph"] > 0)[..., None]
    eps_q = np.where(mask, (out["z_q"] - out["mu_q"])
                     / np.exp(out["logs_q"]), 0.0).astype(np.float32)
    return out, eps_q


def test_training_forward_matches_jax(lockstep):
    """The training branch of ``VISinger.forward`` with JAX's eps_q and
    ids_slice injected: kl, f0_pred, ph_pred, z_p and the decoded slice."""
    ref, eps_q = jax_draws(lockstep, lockstep["jstate"])
    raw, model = lockstep["raw"], lockstep["model"]
    stft = pstft.STFTParams.from_config(lockstep["cfg"])
    ins = {k: torch.from_numpy(v) for k, v in raw.items()}
    model.eval()
    with torch.no_grad():
        out = model(ins["text_tokens"].long(), ins["note_pitch"].long(),
                    ins["note_dur"].long(), ins["mel2ph"].long(),
                    spk_id=ins["spk_ids"].long(), infer=False, f0=ins["f0"],
                    uv=ins["uv"], spec=pstft.power_spectrogram(ins["wavs"],
                                                               stft),
                    lengths=ins["mel_lengths"], eps_q=torch.from_numpy(eps_q),
                    ids_slice=torch.from_numpy(ref["ids_slice"]))
    np.testing.assert_array_equal(out["ids_slice"].numpy(), ref["ids_slice"])
    assert abs(float(out["kl"]) - float(ref["kl"])) < 1e-4 * abs(
        float(ref["kl"]))
    for key in ("f0_pred", "ph_pred", "z_p"):
        assert max_err(out[key], ref[key]) < 1e-4, key
    peak = float(np.abs(ref["wav_out"]).max())
    assert peak > 1e-3
    assert max_err(out["wav_out"], ref["wav_out"]) < 1e-4 * peak


def test_train_step_two_step_lockstep_with_jax(lockstep):
    """Two steps of the port's ``train_step`` against the jitted JAX step
    from the same parameters, with the JAX draws handed to the port: every
    metric within 1e-4 relative at each step; the gated-off step 0 leaves
    the discriminator and its Adam state untouched."""
    cfg, raw = lockstep["cfg"], lockstep["raw"]
    model, disc = lockstep["model"], lockstep["disc"]
    jstate = lockstep["jstate"]
    state = create_train_state(model, disc, seed=0)
    train_step = make_train_step(cfg, model, disc, device="cpu")
    d_before = [p.detach().clone() for p in disc.parameters()]
    for step in range(2):
        ref_out, eps_q = jax_draws(lockstep, jstate)
        jstate, ref = lockstep["step_fn"](jstate, lockstep["jbatch"])
        state, got = train_step(state, raw, eps_q=eps_q,
                                ids_slice=ref_out["ids_slice"])
        assert set(got) == set(ref)
        for k in ref:
            r, g = float(ref[k]), float(got[k])
            assert np.isfinite(g), k
            assert abs(g - r) <= 1e-4 * abs(r) + 1e-7, (step, k, g, r)
        if step == 0:
            assert float(got["disc"]) == 0.0
            assert all(torch.equal(p, p0) for p, p0 in
                       zip(disc.parameters(), d_before))
            assert state.opt_state_d.count == 0
            assert all(float(m.abs().max()) == 0 for m in
                       state.opt_state_d.mu + state.opt_state_d.nu)
    assert state.step == 2 and state.opt_state_d.count == 1
    assert any(not torch.equal(p, p0) for p, p0 in
               zip(disc.parameters(), d_before))
