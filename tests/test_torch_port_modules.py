"""The port's shared layers, score encoder and decoder against the JAX
package, weights carried across by ``params_from_jax``; plus the recipe and
the converter's refusals.

Tolerance 1e-5 max abs in float32 unless stated: the same arithmetic summed
in another order."""

import dataclasses
from collections.abc import Mapping
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visinger_tpu.config import load_config
from visinger_tpu.models.factory import tiny_config as jax_tiny_config
from visinger_tpu.modules import common as jc
from visinger_tpu.modules.encoders import TextEncoder as JTextEncoder
from visinger_tpu.modules.hifigan import HiFiGANGenerator as JHiFiGAN
from visinger_tpu.ops.expand import expand_states as j_expand_states
from visinger_tpu.ops.masking import sequence_mask as j_sequence_mask
from visinger_tpu_torch import config as port_config
from visinger_tpu_torch.convert import params_from_jax
from visinger_tpu_torch.modules import common as pc
from visinger_tpu_torch.modules.encoders import TextEncoder
from visinger_tpu_torch.modules.hifigan import HiFiGANGenerator
from visinger_tpu_torch.ops.expand import expand_states
from visinger_tpu_torch.ops.masking import prefix_lengths, sequence_mask

import test_torch_port_cores  # noqa: F401  (shares the cores)

ATOL = 1e-5


def load_port(module, jax_params, path="m"):
    tree = jax.tree.map(np.asarray, jax_params)
    for key in reversed(path.split(".")):
        tree = {key: tree}
    sd = params_from_jax(tree)
    module.load_state_dict({k[len(path) + 1:]: v for k, v in sd.items()},
                           strict=True)
    return module


def perturb_g(params, seed=0):
    """Weight-norm g away from its init ||v||, so the norm axis matters."""
    rng = np.random.RandomState(seed)
    params = jax.tree.map(np.asarray, params)
    params["g"] = params["g"] * rng.uniform(0.5, 1.5, params["g"].shape
                                            ).astype(np.float32)
    return params


def fill_params(shapes, seed):
    """Random values for a JAX param tree of ShapeDtypeStructs.  Weight-norm
    g is drawn away from ||v|| and every ``post`` is nonzero, so neither the
    norm axis nor the flow can hide a fault."""
    rng = np.random.RandomState(seed)

    def fill(node):
        out = {}
        for k, v in node.items():
            if isinstance(v, dict):
                out[k] = fill(v)
                continue
            shape = v.shape
            if k == "kernel":
                bound = float(np.prod(shape[:-1])) ** -0.5
                out[k] = rng.uniform(-bound, bound, shape)
            elif k == "bias":
                out[k] = rng.uniform(-0.1, 0.1, shape)
            elif k == "embedding":
                out[k] = rng.randn(*shape) * 0.3
            elif k == "gamma":
                out[k] = 1.0 + 0.1 * rng.randn(*shape)
            elif k in ("beta",):
                out[k] = 0.1 * rng.randn(*shape)
            elif k.startswith("emb_rel"):
                out[k] = rng.randn(*shape) * shape[1] ** -0.5
            elif k != "g":
                raise KeyError(k)
        if "g" in node:
            v = out["kernel"]
            norm = np.sqrt(np.sum(v * v, axis=tuple(range(v.ndim - 1))))
            out["g"] = norm * rng.uniform(0.5, 1.5, norm.shape)
        return {k: (v.astype(np.float32) if isinstance(v, np.ndarray) else v)
                for k, v in out.items()}

    return fill(shapes)


def max_err(a, b):
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


def bct(a):
    """numpy [B, T, C] -> torch [B, C, T]."""
    return torch.from_numpy(np.asarray(a, np.float32)).transpose(1, 2)


@pytest.mark.parametrize("k,dilation", [(3, 1), (5, 3), (7, 5)])
def test_conv1d_weight_norm_dilation(k, dilation):
    x = np.random.RandomState(0).randn(2, 30, 6).astype(np.float32)
    jconv = jc.Conv1d(10, k, dilation=dilation, weight_norm=True)
    params = perturb_g(jconv.init(jax.random.PRNGKey(1),
                                  jnp.asarray(x))["params"])
    ref = jconv.apply({"params": params}, jnp.asarray(x))
    port = load_port(pc.Conv1d(6, 10, k, dilation=dilation, weight_norm=True),
                     params)
    assert max_err(port(bct(x)).transpose(1, 2).detach(), ref) < ATOL


@pytest.mark.parametrize("k,u", [(11, 5), (7, 3), (4, 2)])
def test_conv_transpose_every_recipe_rate(k, u):
    x = np.random.RandomState(1).randn(2, 13, 8).astype(np.float32)
    jconv = jc.ConvTranspose1d(4, k, u)
    params = perturb_g(jconv.init(jax.random.PRNGKey(2),
                                  jnp.asarray(x))["params"])
    ref = jconv.apply({"params": params}, jnp.asarray(x))
    port = load_port(pc.ConvTranspose1d(8, 4, k, u), params,
                     path="decoder.up_0")
    out = port(bct(x)).transpose(1, 2).detach()
    assert out.shape == ref.shape == (2, 13 * u, 4)
    assert max_err(out, ref) < ATOL


def test_channel_layer_norm():
    x = np.random.RandomState(2).randn(2, 9, 12).astype(np.float32) * 3 + 1
    jln = jc.ChannelLayerNorm()
    params = jax.tree.map(np.asarray,
                          jln.init(jax.random.PRNGKey(0), jnp.asarray(x))[
                              "params"])
    rng = np.random.RandomState(3)
    params["gamma"] = rng.randn(12).astype(np.float32)
    params["beta"] = rng.randn(12).astype(np.float32)
    ref = jln.apply({"params": params}, jnp.asarray(x))
    port = load_port(pc.ChannelLayerNorm(12), params)
    assert max_err(port(bct(x)).transpose(1, 2).detach(), ref) < ATOL


@pytest.mark.parametrize("dim", [16, 17])
def test_positional_embedding_and_table(dim):
    mask = (np.arange(20)[None, :] < np.array([20, 11])[:, None]).astype(
        np.float32)
    ref = jc.positional_embedding(jnp.asarray(mask), dim)
    out = pc.positional_embedding(torch.from_numpy(mask), dim)
    assert max_err(out, ref) < ATOL
    np.testing.assert_array_equal(pc.sinusoidal_table(30, dim),
                                  jc.sinusoidal_table(30, dim))


def test_expand_states():
    rng = np.random.RandomState(4)
    h = rng.randn(2, 7, 5).astype(np.float32)
    mel2ph = np.array([[1, 1, 2, 3, 3, 3, 7, 0, 0],
                       [1, 2, 2, 2, 4, 5, 6, 6, 0]], np.int32)
    ref = j_expand_states(jnp.asarray(h), jnp.asarray(mel2ph))
    out = expand_states(torch.from_numpy(h), torch.from_numpy(mel2ph))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_sequence_mask_and_prefix_lengths():
    lengths = np.array([7, 3, 0], np.int32)
    ref = np.asarray(j_sequence_mask(jnp.asarray(lengths), 9))
    mask = sequence_mask(torch.from_numpy(lengths), 9)
    np.testing.assert_array_equal(mask.numpy(), ref)
    got = prefix_lengths(mask.float()[..., None])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), lengths)


def test_text_encoder_with_scrambled_positions():
    """Token positions are reshaped [B,T,H]->[B,H,T] and transposed, as in
    the reference; the port must reproduce the scramble, not fix it."""
    rng = np.random.RandomState(5)
    b, n, h = 2, 10, 16
    lens = np.array([10, 6])
    tok = np.zeros((3, b, n), np.int32)
    for i, ln in enumerate(lens):
        tok[:, i, :ln] = rng.randint(1, 20, size=(3, ln))
    mel2ph = np.zeros((b, 30), np.int32)
    mel2ph[0] = np.repeat(np.arange(1, 11), 3)
    mel2ph[1, :18] = np.repeat(np.arange(1, 7), 3)
    jenc = JTextEncoder(20, 20, 20, h, 32, 2, 2, 3, 0.0, attn_impl="legacy")
    jargs = [jnp.asarray(a) for a in (*tok, mel2ph)]
    shapes = jax.eval_shape(jenc.init, jax.random.PRNGKey(0), *jargs)
    params = fill_params(shapes["params"], 5)
    ref = jax.jit(jenc.apply)({"params": params}, *jargs)
    port = load_port(TextEncoder(20, 20, 20, h, 32, 2, 2, 3), params)
    out = port(*(torch.from_numpy(a).long() for a in (*tok, mel2ph)))
    assert max_err(out.detach(), ref) < ATOL
    port.use_pos_embed = False  # the positions do reach the output
    assert max_err(port(*(torch.from_numpy(a).long()
                          for a in (*tok, mel2ph))).detach(), ref) > 1e-2


def test_hifigan_tiny_width():
    """Tolerance 1e-4: five upsampling stages of convolutions (the
    transposed ones and dilated resblocks) accumulate rounding."""
    rng = np.random.RandomState(6)
    x = rng.randn(1, 6, 16).astype(np.float32)
    g = rng.randn(1, 1, 8).astype(np.float32)
    jgen = JHiFiGAN(upsample_initial_channel=32, gin_channels=8)
    jargs = (jnp.asarray(x), jnp.asarray(g))
    # traced, not run: linen's eager init of ~60 convolutions takes seconds
    shapes = jax.eval_shape(jgen.init, jax.random.PRNGKey(0), *jargs)
    params = fill_params(shapes["params"], 6)
    ref = jax.jit(jgen.apply)({"params": params}, *jargs)
    port = load_port(HiFiGANGenerator(16, upsample_initial_channel=32,
                                      gin_channels=8), params, path="decoder")
    out = port(bct(x), bct(g)).detach()
    assert out.shape == ref.shape == (1, 6 * 300)
    assert max_err(out, ref) < 1e-4


def _as_tuples(v):
    if isinstance(v, (list, tuple)):
        return tuple(_as_tuples(e) for e in v)
    if isinstance(v, Mapping):
        return {k: _as_tuples(v[k]) for k in v}
    return v


# keys the YAML leaves out, with the default the JAX code reads them with
# (models/visinger.py, models/factory.py, training/train_step.py,
# infer/infer.py, infer/vocoder.py, training/trainer.py, data/dataset.py,
# data/device_store.py, data/binarizer.py, data/wav_processors.py, run.py;
# ``exp_name`` is run.py's --exp_name default; JAX
# reads a missing ``binary_data_dirs`` as None, the port an empty tuple:
# both mean one corpus)
_JAX_CODE_DEFAULTS = {"slice_ref_padded": False, "disc_s_base": 16,
                      "disc_p_channels": (32, 128, 512, 1024),
                      "remat_policy": "none", "sp_infer": False,
                      "griffin_lim_iters": 30, "exp_name": "",
                      "binary_data_dirs": (), "cache_dataset": True,
                      "device_resident_data": True,
                      "device_data_max_mb": 4096, "store_wav_f32": True,
                      "ship_wav_int16": False, "save_codes": True,
                      "profile_dir": "", "profile_start_step": 10,
                      "binarize_workers": 0, "loud_norm_db": -20.0,
                      "vad_max_silence_length": 12, "synth_n_items": 12,
                      "synth_notes": (4, 8), "render_valid": False,
                      "test_after_train": False}


@pytest.mark.parametrize("which", ["visinger_csd", "tiny", "tpu_run",
                                   "soak_r5", "parity_run"])
def test_recipe_matches_yaml(which):
    if which == "tiny":
        port, ref = port_config.tiny_config(), jax_tiny_config()
    elif which in ("tpu_run", "soak_r5", "parity_run"):
        port = getattr(port_config, which)()
        ref = load_config(str(Path(__file__).resolve().parents[1]
                              / "configs" / f"{which}.yaml"))
    else:
        port, ref = port_config.visinger_csd(), load_config(name="visinger_csd")
    for f in dataclasses.fields(port):
        want = ref.get(f.name, _JAX_CODE_DEFAULTS.get(f.name, KeyError))
        assert _as_tuples(getattr(port, f.name)) == _as_tuples(want), f.name
    # the argument dicts are read-only, by key and by attribute
    assert port.preprocess_args.num_frame == \
        port.preprocess_args["num_frame"] == 3
    with pytest.raises(AttributeError):
        port.binarization_args.min_text = 1
    assert hash(port) == hash(port.replace())


def test_config_json_round_trip_and_overrides_match_jax():
    """``to_dict``/``from_dict`` through JSON give the same config;
    ``parse_overrides`` gives JAX's nested dict; ``apply`` takes dotted keys
    into the argument dicts, makes lists tuples and refuses unknown keys."""
    import json

    from visinger_tpu.config import parse_overrides as j_parse

    cfg = port_config.visinger_csd()
    assert port_config.Config.from_dict(json.loads(json.dumps(
        cfg.to_dict()))) == cfg
    spec = ("max_updates=8,frame_buckets=[160, 320],lr=2e-4,"
            "binarization_args.min_text=2,work_dir='ckpt/a',"
            "dec_dilation_sizes=[[1, 3], [1, 3]],deterministic_eval=False")
    over = port_config.parse_overrides(spec)
    assert over == j_parse(spec)
    new = cfg.apply(over)
    assert (new.max_updates, new.frame_buckets, new.lr, new.work_dir) == \
        (8, (160, 320), 2e-4, "ckpt/a")
    assert new.dec_dilation_sizes == ((1, 3), (1, 3))
    assert new.binarization_args.min_text == 2
    assert new.binarization_args.with_f0 and not new.deterministic_eval
    for bad in ("no_such_key=1", "binarization_args.no_such_arg=1"):
        with pytest.raises(KeyError):
            cfg.apply(port_config.parse_overrides(bad))


@pytest.mark.parametrize("hidden,heads,what", [
    (192, 1, "head width 192"),     # dk above 128: the TPU kernel's limit
    (60, 2, None),                  # dk 30: K1/K3 take it padded to 32
    (48, 2, None),                  # C 48: K2 takes it padded to 64
    (180, 2, None),                 # dk 90, C 180 (chip_smoke.py's widths)
    (18, 4, "not a multiple of num_heads")])
def test_kernel_widths_refused_at_build_for_cuda(hidden, heads, what,
                                                 monkeypatch):
    """A CUDA build refuses only the widths the TPU kernels refuse too (a
    head width above 128, channels not split into equal heads), before any
    weight is made; it accepts every other head width and channel count
    (the kernels take them zero-padded on the card); a CPU build runs them
    (plain versions)."""
    from visinger_tpu_torch.config import check_supported
    from visinger_tpu_torch.infer.infer import TorchSynthesizer
    from visinger_tpu_torch.models.factory import build_model
    from visinger_tpu_torch.training.train_step import make_train_step

    cfg = port_config.tiny_config().replace(hidden_size=hidden,
                                            num_heads=heads)
    if what is None:
        check_supported(cfg, torch.device("cuda", 0))
        check_supported(cfg, "cuda")
    else:
        with pytest.raises(NotImplementedError, match=what):
            check_supported(cfg, torch.device("cuda", 0))
        with pytest.raises(NotImplementedError, match=what):
            check_supported(cfg, "cuda")
        # the device check of the entry points stubbed: the width refusal
        # comes before any tensor reaches the card
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        with pytest.raises(NotImplementedError, match=what):
            build_model(cfg, 20, 30, 25, device="cuda")
        monkeypatch.undo()
    if hidden % heads:
        return
    check_supported(cfg, "cpu")
    model = build_model(cfg, 20, 30, 25, device="cpu")
    if what is not None:
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        for make in (lambda: TorchSynthesizer(cfg, model, device="cuda"),
                     lambda: make_train_step(cfg, model, None,
                                             device="cuda")):
            with pytest.raises(NotImplementedError, match=what):
                make()
        monkeypatch.undo()
    tokens = torch.ones(1, 6, dtype=torch.long)
    mel2ph = torch.arange(1, 7).repeat_interleave(4)[None]
    with torch.no_grad():
        z_p, mask = model.infer_prior(tokens, tokens, tokens, mel2ph)
        wav = model.decode_frames(z_p, mask)
    assert wav.shape == (1, 24 * cfg.hop_size) and bool(wav.isfinite().all())


def test_converter_raises_on_unknown_leaves():
    conv = {"kernel": np.zeros((3, 2, 4), np.float32),
            "bias": np.zeros(4, np.float32)}
    assert set(params_from_jax({"a": {"c": conv}})) == {"a.c.weight",
                                                        "a.c.bias"}
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_jax({"a": {"c": {**conv, "scale": np.ones(4)}}})
    with pytest.raises(ValueError, match="unconsumed"):
        params_from_jax({"stray": np.ones(3)})
    with pytest.raises(ValueError, match="layout"):
        params_from_jax({"a": {"kernel": np.zeros((1, 2, 3, 4))}})
    # the period discriminator's (kh, 1) conv: [kh, 1, in, out] ->
    # [out, in, kh, 1], weight-normed; without its g it is the
    # spectral-norm layout, a plain weight with the same permutation
    conv2d = {"kernel": np.arange(5 * 2 * 3, dtype=np.float32).reshape(
        5, 1, 2, 3), "g": np.ones(3, np.float32),
        "bias": np.zeros(3, np.float32)}
    sd = params_from_jax({"disc_p2": {"conv_0": conv2d}})
    assert sd["disc_p2.conv_0.weight_v"].shape == (3, 2, 5, 1)
    assert float(sd["disc_p2.conv_0.weight_v"][2, 1, 4, 0]) == \
        float(conv2d["kernel"][4, 0, 1, 2])
    sd = params_from_jax({"disc_p2": {"conv_0": {
        k: v for k, v in conv2d.items() if k != "g"}}})
    assert set(sd) == {"disc_p2.conv_0.weight", "disc_p2.conv_0.bias"}
    assert float(sd["disc_p2.conv_0.weight"][2, 1, 4, 0]) == \
        float(conv2d["kernel"][4, 0, 1, 2])
    # every subtree converts, the training-only ones included
    assert set(params_from_jax({"posterior_encoder": {"pre": conv}})) == {
        "posterior_encoder.pre.weight", "posterior_encoder.pre.bias"}
