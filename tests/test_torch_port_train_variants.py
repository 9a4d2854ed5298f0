"""The training settings beside bf16 against the JAX package:
``use_spectral_norm``, ``accumulate_grad_batches``, ``remat_policy``,
``use_spk_embed``, and the warm start from a JAX ``*.msgpack`` checkpoint.

Tolerances (float32): 1e-6 for ``spectral_normalize`` and for parameters
after the optimizer; 1e-5 of the peak for the spectral-norm discriminators
and the voice-embedding prior (the same arithmetic in another order); the
accumulation tests are the port's counterparts of ``tests/test_grad_accum.py``
with its limits (rtol 2e-5, atol 2e-7) and exact zeros; remat's gradients
equal ``none``'s within 1e-6 of their peak with dropout on; a warm start
from a JAX checkpoint gives the parameters ``params_from_jax`` gives, so the
generator's output is the same (1e-6).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visinger_tpu.models.factory import build_models as j_build_models
from visinger_tpu.models.factory import init_params
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.modules.common import \
    spectral_normalize as j_spectral_normalize
from visinger_tpu.modules.discriminator import \
    MultiPeriodDiscriminator as JMPD
from visinger_tpu.training.checkpoint import \
    save_checkpoint as j_save_checkpoint
from visinger_tpu.training.train_state import \
    create_train_state as j_create_train_state
from visinger_tpu.training.train_state import \
    make_optimizers as j_make_optimizers
from visinger_tpu_torch.config import check_supported, tiny_config, \
    visinger_csd
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.data.synthetic import synthetic_batch
from visinger_tpu_torch.models.factory import build_models
from visinger_tpu_torch.modules.common import spectral_normalize
from visinger_tpu_torch.modules.discriminator import MultiPeriodDiscriminator
from visinger_tpu_torch.training.checkpoint import (restore_checkpoint,
                                                    save_checkpoint,
                                                    warm_start)
from visinger_tpu_torch.training.train_state import (create_train_state,
                                                     init_adam,
                                                     make_optimizers)
from visinger_tpu_torch.training.train_step import (_grads, make_train_step,
                                                    remat)
from visinger_tpu_torch.training import losses as PL

from test_torch_port_cores import subprocess_env  # shares the cores
from test_torch_port_kernels import max_err, t
from test_torch_port_modules import fill_params

VOCABS = (40, 96, 64)
ROOT = Path(__file__).resolve().parents[1]


def raw_batch(cfg, seed=0, spk_embed=False):
    raw = synthetic_batch(2, 12, 64, *VOCABS, cfg.num_linear_bins,
                          cfg.hop_size, seed=seed)
    if spk_embed:
        raw["spk_embed"] = np.random.RandomState(seed + 50).randn(
            2, 256).astype(np.float32)
    return raw


# --- settings -------------------------------------------------------------------

@pytest.mark.parametrize("setting", [
    dict(compute_dtype="bfloat16"),
    dict(compute_dtype="bfloat16", bf16_f32_islands=("phoneme", "disc")),
    dict(use_spectral_norm=True), dict(accumulate_grad_batches=2),
    dict(remat_policy="full"), dict(remat_policy="dots"),
    dict(use_spk_embed=True)])
def test_check_supported_takes_the_training_settings(setting):
    for cfg in (tiny_config().replace(**setting),
                visinger_csd().replace(**setting)):
        check_supported(cfg, "cpu")
    check_supported(visinger_csd().replace(**setting), "cuda")


def test_check_supported_still_refuses():
    # sp_infer is taken now (parallel/sp.py), on the CPU and on CUDA, but
    # not together with stream_infer
    for dev in ("cpu", "cuda"):
        check_supported(visinger_csd().replace(sp_infer=True), dev)
    with pytest.raises(ValueError, match="mutually exclusive"):
        check_supported(visinger_csd().replace(sp_infer=True,
                                               stream_infer=True))
    with pytest.raises(KeyError, match="remat_policy"):
        check_supported(visinger_csd().replace(remat_policy="offload"))
    with pytest.raises(ValueError, match="compute_dtype"):
        check_supported(visinger_csd().replace(compute_dtype="float16"))
    with pytest.raises(ValueError, match="islands"):
        check_supported(visinger_csd().replace(bf16_f32_islands=("flows",)))


# --- spectral norm -------------------------------------------------------------

@pytest.mark.parametrize("shape,perm", [((5, 4, 16), (2, 1, 0)),
                                        ((5, 1, 8, 32), (3, 2, 0, 1))])
def test_spectral_normalize_matches_jax(shape, perm):
    """A Conv1d kernel [k, in, out] and a Conv2dP kernel [kh, 1, in, out],
    in the port's layouts; sigma takes no gradient."""
    w = np.random.RandomState(len(shape)).randn(*shape).astype(np.float32)
    ref = np.asarray(jax.jit(j_spectral_normalize)(jnp.asarray(w)))
    wt = t(w).permute(*perm).contiguous().requires_grad_(True)
    got = spectral_normalize(wt)
    inv = np.argsort(perm)
    assert max_err(got.detach().permute(*inv), ref) < 1e-6
    got.sum().backward()       # d(w / sigma) / dw with sigma constant
    sigma = float((wt / got).detach().flatten()[0])
    assert max_err(wt.grad, np.full(wt.shape, 1.0 / sigma)) < 1e-6


def test_spectral_norm_discriminators_match_jax():
    """MPD + MSD with ``use_spectral_norm``: the JAX tree (kernels, no g)
    through ``params_from_jax``; scores and every feature map."""
    rng = np.random.RandomState(22)
    y, y_hat = (rng.randn(2, 2400).astype(np.float32) * 0.3
                for _ in range(2))
    jd = JMPD(periods=(2, 3), s_base=4, p_channels=(8, 16, 32, 32),
              use_spectral_norm=True)
    shapes = jax.eval_shape(jd.init, jax.random.PRNGKey(0), jnp.asarray(y),
                            jnp.asarray(y_hat))
    params = fill_params(shapes["params"], 22)
    assert "g" not in params["disc_s"]["conv_0"]
    ref = jax.jit(jd.apply)({"params": params}, jnp.asarray(y),
                            jnp.asarray(y_hat))
    port = MultiPeriodDiscriminator((2, 3), 4, (8, 16, 32, 32),
                                    use_spectral_norm=True)
    port.load_state_dict(params_from_jax(params), strict=True)
    with torch.no_grad():
        got = port(t(y), t(y_hat))
    for r_list, g_list in zip(ref[:2], got[:2]):
        for r, g in zip(r_list, g_list):
            assert max_err(g, r) < 1e-5 * max(1.0, float(np.abs(r).max()))
    for r_maps, g_maps in zip(ref[2] + ref[3], got[2] + got[3]):
        for r, g in zip(r_maps, g_maps):
            g = g.permute(0, 2, 3, 1) if g.dim() == 4 else g.transpose(1, 2)
            assert max_err(g, r) < 1e-5 * max(1.0, float(np.abs(r).max()))


# --- gradient accumulation ------------------------------------------------------

def test_accumulating_optimizer_matches_optax_multisteps():
    """``ClippedAdamW.step`` with accum 2 against ``make_optimizers``'
    ``optax.MultiSteps`` chain: 6 micro-steps of gradients above and below
    the clip, across two learning-rate decays (2 optimizer steps an
    epoch); the parameters after each micro-step within 1e-6."""
    over = dict(steps_per_epoch=4, scheduler_gamma=0.5,
                accumulate_grad_batches=2)
    jcfg, cfg = jax_tiny_config(**over), tiny_config().replace(**over)
    rng = np.random.RandomState(23)
    shapes = [(3, 4), (5,)]
    init = [rng.randn(*s).astype(np.float32) for s in shapes]
    for j_opt, p_opt in zip(j_make_optimizers(jcfg), make_optimizers(cfg)):
        jparams = {str(i): jnp.asarray(a) for i, a in enumerate(init)}
        jstate = j_opt.init(jparams)
        params = [torch.tensor(a) for a in init]
        state = init_adam(params)
        for step in range(6):
            scale = 3.0 if step % 3 else 0.05
            grads = [rng.randn(*s).astype(np.float32) * scale for s in shapes]
            upd, jstate = j_opt.update(
                {str(i): jnp.asarray(a) for i, a in enumerate(grads)},
                jstate, jparams)
            jparams = jax.tree.map(lambda p, u: p + u, jparams, upd)
            moved = p_opt.step(params, [torch.tensor(a) for a in grads],
                               state, 2)
            assert moved == (step % 2 == 1)
            for i, p in enumerate(params):
                assert max_err(p, jparams[str(i)]) < 1e-6, (step, i)
        assert state.count == 3


@pytest.fixture(scope="module")
def tiny_models():
    cfg = tiny_config()
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    return cfg, model.state_dict(), disc.state_dict()


def fresh(tiny_models, **over):
    """Models of the tiny recipe (``over`` applied) with the module's
    weights, a fresh train state seeded 0 and its train step."""
    cfg = tiny_models[0].replace(**over)
    model, disc = build_models(cfg, *VOCABS, device="cpu")
    model.load_state_dict(tiny_models[1])
    disc.load_state_dict(tiny_models[2])
    state = create_train_state(model, disc, seed=0)
    return cfg, state, make_train_step(cfg, model, disc, device="cpu")


def params(module):
    return torch.cat([p.detach().flatten() for p in module.parameters()])


def test_accum2_matches_accum1_on_identical_microbatches(tiny_models):
    """Two accum=2 micro-steps on the same batch and the same draws land
    where one accum=1 step lands; after the first, no parameter moved."""
    raw = raw_batch(tiny_models[0])
    _, s1, step1 = fresh(tiny_models)
    _, s2, step2 = fresh(tiny_models, accumulate_grad_batches=2)
    g0, d0 = params(s2.model), params(s2.disc)
    gen_state = s2.generator.get_state()
    step1(s1, raw)
    step2(s2, raw)
    assert torch.equal(params(s2.model), g0)
    assert torch.equal(params(s2.disc), d0)
    assert s2.step == 1 and s2.opt_state_g.count == 0
    s2.generator.set_state(gen_state)      # the same draws again
    step2(s2, raw)
    for a, b in ((s2.model, s1.model), (s2.disc, s1.disc)):
        np.testing.assert_allclose(params(a).numpy(), params(b).numpy(),
                                   rtol=2e-5, atol=2e-7)


def test_disc_gates_count_optimizer_steps(tiny_models):
    """disc_start_steps=1 with accum=2: the discriminator stays put for the
    first two micro-steps (optimizer step 0) and moves after micro-steps
    3-4."""
    raw = raw_batch(tiny_models[0])
    _, s, step = fresh(tiny_models, accumulate_grad_batches=2,
                       disc_start_steps=1)
    d0 = params(s.disc)
    for i in range(2):
        _, m = step(s, raw)
        assert torch.equal(params(s.disc), d0), i
        assert float(m["disc"]) == 0.0
    for _ in range(2):
        _, m = step(s, raw)
    assert not torch.equal(params(s.disc), d0)
    assert float(m["disc"]) > 0.0 and s.opt_state_d.count == 1


def test_kl_warmup_counts_optimizer_steps(tiny_models):
    """kl_start_steps=2 with accum=2: the micro-steps of optimizer step 0
    see a zero KL weight, those of optimizer step 1 a half."""
    raw = raw_batch(tiny_models[0])
    _, s, step = fresh(tiny_models, accumulate_grad_batches=2,
                       kl_start_steps=2)
    kls = []
    for _ in range(4):
        _, m = step(s, raw)
        kls.append((float(m["kl"]), float(m["kl_v"])))
    for kl, kl_v in kls[:2]:
        assert kl == 0.0 and kl_v > 0.0
    for kl, kl_v in kls[2:]:
        assert abs(kl - 0.5 * kl_v) < 1e-4 * max(kl_v, 1.0)


def test_accumulation_survives_a_checkpoint(tiny_models, tmp_path):
    """A checkpoint written between two micro-steps holds the running
    mean: restored into a fresh state, the next micro-step lands where the
    uninterrupted run lands."""
    raw = raw_batch(tiny_models[0])
    _, s, step = fresh(tiny_models, accumulate_grad_batches=2)
    step(s, raw)
    path = save_checkpoint(str(tmp_path), s)
    _, r, step_r = fresh(tiny_models, accumulate_grad_batches=2)
    restore_checkpoint(path, r)
    assert r.opt_state_g.mini_step == 1
    assert all(torch.equal(a, b) for a, b in zip(r.opt_state_g.acc,
                                                 s.opt_state_g.acc))
    step(s, raw)
    step_r(r, raw)
    assert torch.equal(params(s.model), params(r.model))


# --- remat -----------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_gradients_equal_none(tiny_models, policy):
    """With dropout on (the tiny recipe's 0.1), the generator's and the
    discriminator's gradients under ``policy`` equal ``none``'s: the
    recompute draws the forward's noise, slices and masks again."""
    raw = raw_batch(tiny_models[0])
    grads = {}
    for pol in ("none", policy):
        cfg, s, step = fresh(tiny_models, remat_policy=pol)
        assert cfg.p_dropout > 0
        total, _, aux = remat(pol, lambda: step.generator_loss(s, raw),
                              s.generator)
        g_gen = _grads(total, list(s.model.parameters()))

        def disc_loss():
            real_scores, fake_scores, _, _ = s.disc(aux["real"].detach(),
                                                    aux["wav_out"].detach())
            return PL.discriminator_loss(real_scores, fake_scores)

        loss_d = remat(pol, disc_loss, s.generator)
        g_disc = _grads(loss_d, list(s.disc.parameters()))
        grads[pol] = (g_gen, g_disc, s.generator.get_state())
    ref, got = grads["none"], grads[policy]
    assert torch.equal(ref[2], got[2])   # the same draws, then none more
    for r_list, g_list in zip(ref[:2], got[:2]):
        for r, g in zip(r_list, g_list):
            peak = max(float(r.abs().max()), 1e-30)
            assert float((g - r).abs().max()) <= 1e-6 * max(peak, 1.0)


# --- voice embeddings ---------------------------------------------------------------

def test_spk_embed_forward_matches_jax():
    """A ``use_spk_embed`` model (spk_embed_proj beside the speaker id) on
    a batch with voice embeddings: the training branch with JAX's draws,
    f0_pred, mu_p and logs_p within 1e-5 of JAX's, z_p within 1e-5 of its
    peak and the decoded slice within 1e-4 of its peak."""
    small = dict(p_dropout=0.0, use_spk_embed=True, dec_kernel_size=(3,),
                 dec_dilation_sizes=((1, 3),))
    jcfg, cfg = jax_tiny_config(**small), tiny_config().replace(**small)
    raw = raw_batch(cfg, seed=3, spk_embed=True)
    jb = {k: jnp.asarray(v) for k, v in raw.items()}
    jmodel, jdisc = j_build_models(jcfg, *VOCABS)
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, jdisc, raw))
    params_g = fill_params(shapes[0], 24)
    assert params_g["spk_embed_proj"]["kernel"].shape == (256, 8)
    out = jax.jit(lambda p: jmodel.apply(
        {"params": p}, text_tokens=jb["text_tokens"],
        pitch_tokens=jb["note_pitch"], dur_tokens=jb["note_dur"],
        mel2ph=jb["mel2ph"], spk_embed=jb["spk_embed"],
        spk_id=jb["spk_ids"], f0=jb["f0"], uv=jb["uv"], spec=jb["spec"],
        lengths=jb["mel_lengths"], infer=False, deterministic=False,
        rngs={"sample": jax.random.PRNGKey(5)}))(params_g)
    ref = {k: np.asarray(v) for k, v in out.items()}
    mask = (raw["mel2ph"] > 0)[..., None]
    eps_q = np.where(mask, (ref["z_q"] - ref["mu_q"])
                     / np.exp(ref["logs_q"]), 0.0).astype(np.float32)
    model, _ = build_models(cfg, *VOCABS, device="cpu")
    model.load_state_dict(params_from_jax(params_g), strict=True)
    ins = {k: torch.from_numpy(v) for k, v in raw.items()}
    with torch.no_grad():
        got = model(ins["text_tokens"].long(), ins["note_pitch"].long(),
                    ins["note_dur"].long(), ins["mel2ph"].long(),
                    spk_id=ins["spk_ids"].long(), infer=False, f0=ins["f0"],
                    uv=ins["uv"], spec=ins["spec"],
                    lengths=ins["mel_lengths"], eps_q=torch.from_numpy(eps_q),
                    ids_slice=torch.from_numpy(ref["ids_slice"].copy()),
                    spk_embed=ins["spk_embed"])
    for key in ("f0_pred", "mu_p", "logs_p"):
        assert max_err(got[key], ref[key]) < 1e-5, key
    peak = float(np.abs(ref["z_p"]).max())
    assert max_err(got["z_p"], ref["z_p"]) < 1e-5 * peak
    peak = float(np.abs(ref["wav_out"]).max())
    assert max_err(got["wav_out"], ref["wav_out"]) < 1e-4 * peak
    # the voice embedding reaches the output
    with torch.no_grad():
        other = model(ins["text_tokens"].long(), ins["note_pitch"].long(),
                      ins["note_dur"].long(), ins["mel2ph"].long(),
                      spk_id=ins["spk_ids"].long(), infer=True,
                      eps=torch.zeros(2, 64, 16), spk_embed=ins["spk_embed"])
        zero = model(ins["text_tokens"].long(), ins["note_pitch"].long(),
                     ins["note_dur"].long(), ins["mel2ph"].long(),
                     spk_id=ins["spk_ids"].long(), infer=True,
                     eps=torch.zeros(2, 64, 16),
                     spk_embed=torch.zeros(2, 256))
    assert not torch.equal(other["wav_out"], zero["wav_out"])


# --- warm start from a JAX checkpoint ----------------------------------------------

def test_warm_start_from_a_jax_msgpack(tmp_path):
    """``warm_start`` on a ``model_ckpt_steps_0.msgpack`` that the JAX
    package's ``save_checkpoint`` writes: the port's parameters are those
    ``params_from_jax`` gives, so the generator's output is the same; the
    step and the Adam states stay fresh; the file is read with neither
    ``msgpack`` nor ``flax`` importable."""
    small = dict(dec_kernel_size=(3,), dec_dilation_sizes=((1, 3),))
    jcfg, cfg = jax_tiny_config(**small), tiny_config().replace(**small)
    raw = raw_batch(cfg, seed=4)
    jmodel, jdisc = j_build_models(jcfg, *VOCABS)
    shapes = jax.eval_shape(lambda: init_params(jcfg, jmodel, jdisc, raw))
    params_g, params_d = fill_params(shapes[0], 25), fill_params(shapes[1],
                                                                 26)
    jstate = j_create_train_state(jcfg, params_g, params_d,
                                  jax.random.PRNGKey(0))
    path = j_save_checkpoint(str(tmp_path), jstate)
    assert path.endswith("model_ckpt_steps_0.msgpack")

    model, disc = build_models(cfg, *VOCABS, device="cpu")
    state = warm_start(path, create_train_state(model, disc, seed=0))
    ref, ref_disc = build_models(cfg, *VOCABS, device="cpu")
    ref.load_state_dict(params_from_jax(params_g), strict=True)
    ref_disc.load_state_dict(params_from_jax(params_d), strict=True)
    for a, b in ((state.model, ref), (state.disc, ref_disc)):
        for (na, pa), (_, pb) in zip(a.state_dict().items(),
                                     b.state_dict().items()):
            assert torch.equal(pa, pb), na
    assert state.step == 0 and state.opt_state_g.count == 0
    ins = {k: torch.from_numpy(v) for k, v in raw.items()}
    eps = torch.from_numpy(np.random.RandomState(6).randn(
        2, 64, 16).astype(np.float32))
    with torch.no_grad():
        wav = [m(ins["text_tokens"].long(), ins["note_pitch"].long(),
                 ins["note_dur"].long(), ins["mel2ph"].long(),
                 spk_id=ins["spk_ids"].long(), infer=True,
                 eps=eps)["wav_out"] for m in (state.model, ref)]
    assert max_err(wav[0], wav[1]) <= 1e-6

    script = (
        "import sys\n"
        "for m in ('msgpack', 'flax', 'jax', 'visinger_tpu'):\n"
        "    sys.modules[m] = None\n"
        "from visinger_tpu_torch.training.checkpoint import load_jax_params\n"
        f"sd = load_jax_params({path!r})\n"
        "print(len(sd['model']), len(sd['disc']))\n")
    out = subprocess.run([sys.executable, "-c", script], cwd=ROOT,
                         env=subprocess_env(), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [str(len(ref.state_dict())),
                                  str(len(ref_disc.state_dict()))]
