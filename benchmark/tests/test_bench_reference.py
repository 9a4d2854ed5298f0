"""The benchmark's plain reference (``benchmark/reference/``) against the
port on the CPU at ``tiny_config``: one training step's losses and updated
parameters, and one ``synthesize_batch`` of 4 requests, from the same
seed-made weights, inputs and generator seeds."""

import numpy as np
import pytest
import torch

import tiny
import traffic
import weights
from reference import discriminator as rdisc
from reference import synth as rsynth
from reference import train as rtrain
from reference import visinger as rvis

SEED = 2 ** 31 + 17


def _configs():
    from visinger_tpu_torch.config import Config

    bcfg = tiny.bench_config()
    return bcfg, Config().apply(bcfg.fields())


def _reference_models(bcfg, train: bool):
    rcfg = bcfg.reference()
    model = rvis.VISinger(rcfg, *bcfg.vocabs)
    disc = rdisc.MultiPeriodDiscriminator(
        tuple(rcfg.disc_periods), rcfg.disc_s_base,
        tuple(rcfg.disc_p_channels), rcfg.disc_pair_batch,
        rcfg.use_spectral_norm) if train else None
    return rcfg, model, disc


def test_reference_leaves_match_the_port():
    from visinger_tpu_torch.models.factory import build_models

    bcfg, cfg = _configs()
    model, disc = build_models(cfg, *bcfg.vocabs, device="cpu")
    _, rmodel, rdisc_ = _reference_models(bcfg, True)
    assert weights.leaf_shapes(("model", model), ("disc", disc)) == \
        weights.leaf_shapes(("model", rmodel), ("disc", rdisc_))


def test_one_training_step_matches_the_port():
    from visinger_tpu_torch.models.factory import build_models
    from visinger_tpu_torch.training.train_state import create_train_state
    from visinger_tpu_torch.training.train_step import make_train_step

    torch.manual_seed(0)
    bcfg, cfg = _configs()
    mix = tiny.mix(tiny.spec(), "train.csd.f32.long")
    batches, starts = traffic.train_pool(mix, bcfg, bcfg.vocabs, SEED)
    eps = torch.randn(batches[0]["mel2ph"].shape + (bcfg.hidden_size,),
                      generator=torch.Generator().manual_seed(1))
    ids = torch.from_numpy(starts[0])

    model, disc = build_models(cfg, *bcfg.vocabs, device="cpu")
    weights.fill(SEED, model=model, disc=disc)
    state = create_train_state(model, disc, seed=5)
    step = make_train_step(cfg, model, disc, device="cpu")
    state, m = step(state, batches[0], eps_q=eps, ids_slice=ids)

    rcfg, rmodel, rdisc_ = _reference_models(bcfg, True)
    weights.fill(SEED, model=rmodel, disc=rdisc_)
    rstate = rtrain.ref_state(rmodel, rdisc_, 5)
    rm = rtrain.RefTrainStep(rcfg, rmodel, rdisc_, "cpu")(
        rstate, batches[0], eps, ids)

    for key in ("total_g", "disc", "mel_l1", "kl_v", "ctc", "fm", "adv"):
        assert float(m[key]) == pytest.approx(float(rm[key]), rel=1e-5), key
    for (name, p), rp in zip(
            list(model.named_parameters()) + list(disc.named_parameters()),
            list(rmodel.parameters()) + list(rdisc_.parameters())):
        torch.testing.assert_close(p.detach(), rp.detach(), rtol=1e-5,
                                   atol=1e-6, msg=name)


def test_synthesize_batch_of_four_matches_the_port():
    from visinger_tpu_torch.infer.infer import TorchSynthesizer
    from visinger_tpu_torch.models.factory import build_model

    bcfg, cfg = _configs()
    mix = tiny.mix(tiny.spec(), "synth.csd.f32.batch")
    book = traffic.SynthBook(mix, bcfg, bcfg.vocabs, SEED)
    group = book.group(0)
    assert len(group) == 4
    model = build_model(cfg, *bcfg.vocabs, device="cpu")
    weights.fill(SEED, model=model)
    wavs = TorchSynthesizer(cfg, model, device="cpu").synthesize_batch(
        group, seed=book.call_seed(0)).wavs

    rcfg, rmodel, _ = _reference_models(bcfg, False)
    weights.fill(SEED, model=rmodel)
    ref = rsynth.synthesize_group(rmodel, group, book.call_seed(0),
                                  rcfg.hop_size, "cpu")
    assert [w.shape for w in wavs] == [r.shape for r in ref]
    for w, r in zip(wavs, ref):
        np.testing.assert_allclose(w, r, rtol=1e-5, atol=1e-6)


def test_tied_frames_are_the_valid_ones_nearest_the_threshold():
    logit = torch.tensor([[4.0, -0.01, 0.02, 3e-5, -8.0, 0.0],
                          [1.0, 2.0, -3.0, 0.5, 0.0, 0.0]])
    valid = torch.tensor([[True] * 5 + [False], [True] * 4 + [False] * 2])
    assert rsynth.tied_frames(logit, valid, 1e-2) == [[3, 1, 2], []]
    assert rsynth.tied_frames(logit, valid, 2e-3) == [[3, 1], []]
    assert rsynth.tied_frames(logit, valid, 0.0) == [[], []]
    many = torch.tensor([[1.0] + [1e-6 * i for i in range(1, 9)]])
    assert rsynth.tied_frames(many, torch.ones_like(many, dtype=torch.bool),
                              1e-3) == [[1, 2, 3, 4][:rsynth.MAX_TIES]]


def test_a_tie_gives_the_waveform_on_each_side_and_the_gap_takes_the_nearer():
    import correct

    bcfg, _ = _configs()
    mix = tiny.mix(tiny.spec(), "synth.csd.f32.batch")
    book = traffic.SynthBook(mix, bcfg, bcfg.vocabs, SEED)
    group = book.group(0)
    _, rmodel, _ = _reference_models(bcfg, False)
    weights.fill(SEED, model=rmodel)
    args = (rmodel, group, book.call_seed(0), bcfg.hop_size, "cpu")
    plain = rsynth.synthesize_group(*args)
    # a tie this wide makes every row try its frames nearest the threshold
    sides = rsynth.candidates(*args, tie=0.5)
    assert [len(s) for s in sides] == [2 ** rsynth.MAX_TIES] * len(group)
    for p, s in zip(plain, sides):
        np.testing.assert_array_equal(p, s[0])
        assert any(np.abs(o - p).max() > 1e-4 * np.abs(p).max()
                   for o in s[1:])
    # served on another side of a tie: far from the plain answer, at no
    # gap from the side it took
    served = [s[-1] for s in sides]
    assert correct.wav_gap(served, plain) > 1e-4
    assert correct.wav_gap(served, sides) == 0.0
