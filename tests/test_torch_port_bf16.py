"""bf16 compute in the port against the JAX package's (``compute_dtype:
bfloat16``, the ``soak_r5`` recipe).

  - K1/K3's plain versions with bf16 q, k, v against the Pallas kernel in
    interpret mode with bf16 inputs (valid rows; g zero at masked rows):
    the bf16 outputs and dq/dk/dv within one bf16 ulp of their peak
    (2^-7 of the peak: the two round the same float32 value, summed in
    another order, to either side of a tie), the float32 emb gradients
    within 1e-5 of their peak;
  - the dtype routes: every subsystem computes in bf16, an island in
    float32, the discriminator follows "disc";
  - one bf16 ``TrainStep`` against JAX's jitted bf16 train step from the
    same parameters with JAX's posterior noise and slice starts: every loss
    within LOSS_REL of JAX's bf16 value, and each reconstruction loss
    farther from JAX's float32 value (its float32 eval step on the same
    draws) than the port's own float32 step lies, so a port that computed
    in float32 would fail.  (Nearer JAX's bf16 value than JAX's bf16 value
    lies to its float32 one does not hold: measured, the two bf16 results
    differ by about as much as JAX's bf16 and float32 do, mel_l1 by 0.16
    against 0.15, uv by 2.3e-4 against 7.9e-6.  XLA on the CPU may keep
    excess precision in its fused elementwise work, where the eager port
    rounds after every op.)  Both sides keep the posterior and the
    flow in float32 (``bf16_f32_islands``): the port runs their WaveNets
    through K2, float32 inside by design, where JAX's bf16 training step
    runs bf16 convolutions (ROADMAP queue 3).
"""

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
from visinger_tpu.training.train_state import \
    create_train_state as j_create_train_state
from visinger_tpu.training.train_step import \
    make_eval_step as j_make_eval_step
from visinger_tpu.training.train_step import \
    make_train_step as j_make_train_step
from visinger_tpu_torch.config import tiny_config
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.modules import transformer
from visinger_tpu_torch.ops.rel_attention import (rel_attention_bwd_plain,
                                                  rel_attention_plain)
from visinger_tpu_torch.training.train_state import create_train_state
from visinger_tpu_torch.training.train_step import make_train_step

import test_torch_port_cores  # noqa: F401  (shares the cores)
from test_torch_port_kernels import (LENGTHS, T_ATT, _attention_inputs,
                                     _pack_heads, t)
from test_torch_port_modules import fill_params

BF16_REL = 2.0 ** -7     # one bf16 ulp of the tensor's peak
EMB_REL = 1e-5           # float32 emb gradients, of their peak
# a bf16 step's losses against JAX's bf16 step: relative, a little above
# bf16's 2^-8 (measured on the CPU: at most 2.5e-3, the adversarial loss of
# a bf16 discriminator; the reconstruction losses 6.7e-4 and below)
LOSS_REL = 5e-3
VOCABS = (40, 96, 64)


def err_of_peak(got, ref) -> float:
    got = np.asarray(torch.as_tensor(got).float() if torch.is_tensor(got)
                     else np.asarray(got, np.float32), np.float64)
    ref = np.asarray(ref, np.float64)
    return float(np.abs(got - ref).max() / np.abs(ref).max())


def bf16(a):
    return torch.from_numpy(np.asarray(a, np.float32)).bfloat16()


def test_rel_attention_bf16_plain_matches_pallas(monkeypatch):
    """Forward and backward with bf16 q, k, v: the plain versions against
    ``_attn_fwd_kernel``/``_attn_bwd_kernel`` in interpret mode."""
    orig = pl.pallas_call
    monkeypatch.setattr(ak.pl, "pallas_call",
                        lambda *a, **k: orig(*a, **{**k, "interpret": True}))
    heads, window = 2, 4
    q, k, v, ek, ev, mask = _attention_inputs(heads=heads, window=window,
                                              seed=3)
    dk = ek.shape[1]
    scale = dk ** -0.5
    g = np.random.RandomState(9).randn(*q.shape).astype(np.float32) * mask
    b = len(LENGTHS)
    # the same bf16 values on both sides
    q, k, v, g = (np.asarray(bf16(a).float()) for a in (q, k, v, g))

    def f(qp, kp, vp, ek_, ev_):
        return ak.rel_attention(qp, kp, vp, ek_, ev_,
                                jnp.asarray(mask[..., 0]), window=window,
                                scale=scale)

    packed = [jnp.asarray(_pack_heads(a, heads), jnp.bfloat16)
              for a in (q, k, v)]
    ref_out, vjp = jax.vjp(f, *packed, jnp.asarray(ek), jnp.asarray(ev))
    assert ref_out.dtype == jnp.bfloat16
    ref = vjp(jnp.asarray(_pack_heads(g, heads), jnp.bfloat16))

    def unpack(a):
        a = np.asarray(a, np.float32).reshape(b, T_ATT, heads, ak.LANE)
        return a[..., :dk].reshape(b, T_ATT, heads * dk)

    lengths = torch.tensor(LENGTHS)
    out = rel_attention_plain(bf16(q), bf16(k), bf16(v), t(ek), t(ev),
                              lengths, window=window, scale=scale)
    assert out.dtype == torch.bfloat16
    valid = mask[..., 0] > 0
    assert err_of_peak(out.float().numpy()[valid],
                       unpack(ref_out)[valid]) <= BF16_REL
    got = rel_attention_bwd_plain(bf16(q), bf16(k), bf16(v), t(ek), t(ev),
                                  lengths, bf16(g), window=window,
                                  scale=scale)
    for name, a, r in zip(("dq", "dk", "dv"), got[:3], ref[:3]):
        assert a.dtype == torch.bfloat16 and r.dtype == jnp.bfloat16, name
        assert err_of_peak(a, unpack(r)) <= BF16_REL, name
    for name, a, r in zip(("d_emb_rel_k", "d_emb_rel_v"), got[3:], ref[3:]):
        assert a.dtype == torch.float32, name
        assert err_of_peak(a, np.asarray(r)[:2 * window + 1, :dk]) \
            <= EMB_REL, name


def test_bf16_dtype_routes_and_islands(monkeypatch):
    """bf16 compute reaches every subsystem (K1 gets bf16 q, k, v; the
    layers' outputs are bf16), an island computes in float32, the
    discriminator follows the "disc" island, and the parameters, the
    distribution statistics and the waveform stay float32."""
    seen = []
    orig = transformer.rel_attention

    def spy(q, *a, **kw):
        seen.append(q.dtype)
        return orig(q, *a, **kw)

    monkeypatch.setattr(transformer, "rel_attention", spy)
    cfg = tiny_config().replace(compute_dtype="bfloat16",
                                bf16_f32_islands=("phoneme", "disc"))
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.text_encoder.encoder.attn_0.dtype == torch.bfloat16
    assert model.phoneme_predictor.encoder.attn_0.dtype == torch.float32
    assert model.decoder.conv_pre.dtype == torch.bfloat16
    assert disc.disc_s.conv_0.dtype == torch.float32
    _, disc16 = build_models(cfg.replace(bf16_f32_islands=()), *VOCABS,
                             device="cpu")
    assert disc16.disc_p2.conv_0.dtype == torch.bfloat16

    outs = {}

    def record(name):
        def hook(_m, _i, o):
            outs.setdefault(name, o.dtype)
        return hook

    for name, mod in (("text", model.text_encoder.encoder.ffn_0.conv_2),
                      ("pitch", model.pitch_predictor.encoder.norm2_0),
                      ("prior", model.frame_prior.proj),
                      ("posterior", model.posterior_encoder.proj),
                      ("flow", model.flow.coupling_0.post),
                      ("phoneme", model.phoneme_predictor.encoder.ffn_0
                       .conv_2),
                      ("decoder", model.decoder.conv_post)):
        mod.register_forward_hook(record(name))
    raw = synthetic_batch(2, 12, 64, *VOCABS, cfg.num_linear_bins,
                          cfg.hop_size, seed=0)
    step = make_train_step(cfg, model, disc, device="cpu")
    _, losses, aux = step.generator_loss(create_train_state(model, disc, 0),
                                         raw)
    assert outs == {"text": torch.bfloat16, "pitch": torch.bfloat16,
                    "prior": torch.bfloat16, "posterior": torch.bfloat16,
                    "flow": torch.bfloat16, "phoneme": torch.float32,
                    "decoder": torch.bfloat16}
    # text encoder, pitch predictor and frame prior in bf16, the phoneme
    # island in float32 (one layer each at tiny size)
    assert seen == [torch.bfloat16] * 3 + [torch.float32]
    assert aux["wav_out"].dtype == torch.float32
    assert all(v.dtype == torch.float32 for v in losses.values())


@pytest.fixture(scope="module")
def bf16_pair():
    """JAX and port models of the tiny recipe in bf16 (posterior and flow
    islands), dropout off, one decoder resblock per stage, parameters
    filled from a seed."""
    small = dict(p_dropout=0.0, dec_kernel_size=(3,),
                 dec_dilation_sizes=((1, 3),), compute_dtype="bfloat16",
                 bf16_f32_islands=("posterior", "flow"))
    jcfg = jax_tiny_config(**small)
    cfg = tiny_config().replace(**small)
    raw = synthetic_batch(2, 12, 64, *VOCABS, cfg.num_linear_bins,
                          cfg.hop_size, seed=0)
    raw.pop("spec")
    jbatch = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel, jdisc = j_build_models(jcfg, *VOCABS)
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, jdisc, raw))
    params_g = fill_params(shapes[0], 30)
    params_d = fill_params(shapes[1], 31)
    jstate = j_create_train_state(jcfg, params_g, params_d,
                                  jax.random.PRNGKey(4))
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    model.load_state_dict(params_from_jax(params_g), strict=True)
    disc.load_state_dict(params_from_jax(params_d), strict=True)
    return dict(jcfg=jcfg, cfg=cfg, raw=raw, jbatch=jbatch, jstate=jstate,
                jmodel=jmodel, jdisc=jdisc, model=model, disc=disc)


def test_bf16_train_step_matches_jax(bf16_pair):
    """The port's bf16 step against JAX's jitted bf16 step with JAX's
    draws: each loss within LOSS_REL of JAX's bf16 value, and, for the
    reconstruction losses, farther from JAX's float32 value (its eval step
    on the same draws) than the port's own float32 step is."""
    p = bf16_pair
    jstate, jbatch = p["jstate"], p["jbatch"]
    _, k_sample, _ = jax.random.split(jstate.rng, 3)
    # JAX's draws: one bf16 training apply with the step's sample key; the
    # posterior noise from z_q = mu_q + eps exp(logs_q) (float32 there)
    out = jax.jit(lambda prm: p["jmodel"].apply(
        {"params": prm}, text_tokens=jbatch["text_tokens"],
        pitch_tokens=jbatch["note_pitch"], dur_tokens=jbatch["note_dur"],
        mel2ph=jbatch["mel2ph"], spk_id=jbatch["spk_ids"], f0=jbatch["f0"],
        uv=jbatch["uv"], spec=_spec(p), lengths=jbatch["mel_lengths"],
        infer=False, deterministic=False,
        rngs={"sample": k_sample}))(jstate.params_g)
    out = {k: np.asarray(v, np.float32) for k, v in out.items()}
    mask = (p["raw"]["mel2ph"] > 0)[..., None]
    eps_q = np.where(mask, (out["z_q"] - out["mu_q"])
                     / np.exp(out["logs_q"]), 0.0).astype(np.float32)
    _, ref16 = jax.jit(j_make_train_step(p["jcfg"], p["jmodel"],
                                         p["jdisc"]))(jstate, jbatch)
    jcfg32 = p["jcfg"].replace(compute_dtype="float32")
    jmodel32, _ = j_build_models(jcfg32, *VOCABS)
    ref32 = jax.jit(j_make_eval_step(jcfg32, jmodel32))(
        jstate.params_g, jbatch, k_sample)
    got = {}
    for dtype in ("bfloat16", "float32"):
        cfg = p["cfg"].replace(compute_dtype=dtype)
        model, disc = build_models(cfg, *VOCABS, device="cpu")
        model.load_state_dict(p["model"].state_dict(), strict=True)
        disc.load_state_dict(p["disc"].state_dict(), strict=True)
        step = make_train_step(cfg, model, disc, device="cpu")
        _, got[dtype] = step(create_train_state(model, disc, seed=0),
                             p["raw"], eps_q=eps_q,
                             ids_slice=out["ids_slice"])
    for k in ("kl_v", "mel_l1", "uv", "f0", "ctc", "adv", "fm", "disc"):
        g, r16 = float(got["bfloat16"][k]), float(ref16[k])
        assert np.isfinite(g), k
        assert abs(g - r16) <= LOSS_REL * abs(r16), (k, g, r16)
    for k, k32 in (("kl_v", "kl"), ("mel_l1", "mel_l1"), ("uv", "uv"),
                   ("f0", "f0"), ("ctc", "ctc")):
        g16, g32 = float(got["bfloat16"][k]), float(got["float32"][k])
        r32 = float(ref32[k32])
        assert abs(g16 - r32) > abs(g32 - r32), (k, g16, g32, r32)


def _spec(p):
    from visinger_tpu.ops import stft as jstft

    c = p["jcfg"]
    return jstft.power_spectrogram(p["jbatch"]["wavs"], jstft.STFTParams(
        c.fft_size, c.win_size, c.hop_size, c.sample_rate, float(c.fmin),
        float(c.fmax), c.num_mel_bins))
