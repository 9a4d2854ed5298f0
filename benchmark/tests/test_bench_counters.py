"""The yardstick's counters (``benchmark/counters.py``): the frozen kernel
work counters against ``chip_smoke.py``'s at the shapes of the kernel
table, and the model FLOP counter against ``torch.utils.flop_counter``'s
count of the plain reference at a small size."""

import pytest
import torch
from torch.utils import flop_counter as fc

import chip_smoke
import counters
import tiny
import traffic
import weights
from reference import discriminator as rdisc
from reference import synth as rsynth
from reference import train as rtrain
from reference import visinger as rvis

# (lengths, T, C) of the kernel table's K1/K3 rows (2 heads, window 4)
ATTN = [([640, 600, 517, 333], 640, 192), ([192, 180, 151, 97], 192, 192),
        ([637, 600, 64, 1], 637, 192), ([640, 600, 517, 333], 640, 128),
        ([100, 37], 100, 256), ([1237], 1280, 192)]
# (lengths, T, C, layers) of its K2 rows (kernel 5)
STACK = [([640, 600, 517, 333], 640, 192, 4),
         ([640, 600, 517, 333], 640, 192, 16), ([1237], 1280, 192, 4),
         ([366], 366, 192, 4)]


@pytest.mark.parametrize("lengths,t,c", ATTN)
def test_attention_work_is_chip_smokes(lengths, t, c):
    assert counters.k1_work(lengths, t, c, 2, 4) == \
        chip_smoke.k1_work(lengths, t, c, 2, 4)
    assert counters.k3_work(lengths, t, c, 2, 4) == \
        chip_smoke.k3_work(lengths, t, c, 2, 4)


@pytest.mark.parametrize("lengths,t,c,layers", STACK)
def test_stack_work_is_chip_smokes(lengths, t, c, layers):
    assert counters.k2_work(lengths, t, c, layers, 5) == \
        chip_smoke.k2_work(lengths, t, c, layers, 5)


def _conv_backward_per_group(grad_out_shape, x_shape, w_shape, bias, stride,
                             padding, dilation, transposed, output_padding,
                             groups, output_mask, out_shape=None, **kw):
    """``flop_counter``'s convolution backward with a grouped weight
    gradient counted per group (it counts every group's products against
    every channel)."""
    raw = fc.conv_backward_flop.__wrapped__
    flops = raw(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                dilation, transposed, output_padding, groups, output_mask,
                out_shape=out_shape)
    if output_mask[1] and groups > 1 and not transposed:
        def t(shape):
            return [shape[1], shape[0]] + list(shape[2:])

        whole = fc.conv_flop_count(t(x_shape), t(grad_out_shape),
                                   t(out_shape[1]))
        flops -= whole - whole // groups
    return flops


def _count(fn) -> int:
    mode = fc.FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_per_group})
    with mode:
        fn()
    return mode.get_total_flops()


SEED = 99


@pytest.mark.parametrize("frames", [(64, 128), (96, 96)])
def test_train_step_flops_match_flop_counter(frames):
    bcfg = tiny.bench_config()
    rcfg = bcfg.reference()
    mix = tiny.mix(tiny.spec(), "train.csd.f32.long")
    mix.update(frames=list(frames))
    batches, starts = traffic.train_pool(mix, bcfg, bcfg.vocabs, SEED)
    batch = batches[0]
    model = rvis.VISinger(rcfg, *bcfg.vocabs)
    disc = rdisc.MultiPeriodDiscriminator(
        tuple(rcfg.disc_periods), rcfg.disc_s_base,
        tuple(rcfg.disc_p_channels), rcfg.disc_pair_batch,
        rcfg.use_spectral_norm)
    weights.fill(SEED, model=model, disc=disc)
    state = rtrain.ref_state(model, disc, 3)
    step = rtrain.RefTrainStep(rcfg, model, disc, "cpu")
    eps = torch.zeros(batch["mel2ph"].shape + (bcfg.hidden_size,))
    counted = _count(lambda: step(state, batch, eps,
                                  torch.from_numpy(starts[0])))
    b, n = batch["text_tokens"].shape
    analytic = counters.train_step_flops(bcfg, b, n, batch["mel2ph"].shape[1])
    assert analytic == counted


def test_synth_flops_match_flop_counter():
    bcfg = tiny.bench_config()
    rcfg = bcfg.reference()
    book = traffic.SynthBook(tiny.mix(tiny.spec(), "synth.csd.f32.batch"),
                             bcfg, bcfg.vocabs, SEED)
    model = rvis.VISinger(rcfg, *bcfg.vocabs)
    weights.fill(SEED, model=model)
    for g in range(3):
        group = book.group(g)
        counted = _count(lambda: rsynth.synthesize_group(
            model, group, 1, rcfg.hop_size, "cpu"))
        n = max(len(r["text_tokens"]) for r in group)
        t = max(len(r["mel2ph"]) for r in group)
        assert counters.synth_flops(bcfg, len(group), n, t) == counted
